from repro_torch.train.trainer import make_serve_step

__all__ = ["make_serve_step"]
