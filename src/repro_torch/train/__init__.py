from repro_torch.train.trainer import (TrainSettings, abstract_train_state,
                                       init_train_state, make_arch_optimizer,
                                       make_serve_step, make_train_step)

__all__ = ["TrainSettings", "abstract_train_state", "init_train_state",
           "make_arch_optimizer", "make_serve_step", "make_train_step"]
