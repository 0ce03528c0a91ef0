from repro_torch.nn.layers import (accuracy, dense, micro_f1,
                                   softmax_cross_entropy)
from repro_torch.nn.params import ParamSpec, init_params, params_from_numpy

__all__ = ["ParamSpec", "init_params", "params_from_numpy", "accuracy",
           "dense", "micro_f1", "softmax_cross_entropy"]
