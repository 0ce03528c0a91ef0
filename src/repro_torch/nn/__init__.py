from repro_torch.nn.layers import (accuracy, apply_rope, count_ids, dense,
                                   gelu, gelu_mlp, layer_norm, micro_f1,
                                   rms_norm, rope_freqs,
                                   softmax_cross_entropy, swiglu,
                                   take_rows)
from repro_torch.nn.params import (ParamSpec, abstract_params, init_params,
                                   param_axes, param_bytes, param_count,
                                   params_from_numpy)

__all__ = ["ParamSpec", "abstract_params", "init_params", "param_axes",
           "param_bytes", "param_count", "params_from_numpy", "accuracy",
           "apply_rope", "count_ids", "dense", "gelu", "gelu_mlp",
           "layer_norm", "micro_f1", "rms_norm", "rope_freqs",
           "softmax_cross_entropy", "swiglu", "take_rows"]
