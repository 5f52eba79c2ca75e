from .step import make_serve_step, make_tdg_train_region, make_train_step

__all__ = ["make_serve_step", "make_tdg_train_region", "make_train_step"]
