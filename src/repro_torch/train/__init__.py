"""Step factories: language-model serving (prefill, decode) and the GP front-ends' serve and train steps."""

from repro_torch.train.gp_step import attach_mesh, make_gp_serve_step, make_gp_train_step

__all__ = ["attach_mesh", "make_gp_serve_step", "make_gp_train_step"]
