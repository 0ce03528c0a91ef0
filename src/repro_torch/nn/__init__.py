from repro_torch.nn.layers import (accuracy, apply_rope, dense, micro_f1,
                                   rms_norm, rope_freqs,
                                   softmax_cross_entropy, swiglu,
                                   take_rows)
from repro_torch.nn.params import (ParamSpec, init_params, param_bytes,
                                   param_count, params_from_numpy)

__all__ = ["ParamSpec", "init_params", "param_bytes", "param_count",
           "params_from_numpy", "accuracy",
           "apply_rope", "dense", "micro_f1", "rms_norm", "rope_freqs",
           "softmax_cross_entropy", "swiglu", "take_rows"]
