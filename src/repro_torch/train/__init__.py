"""Step factories: language-model training and serving, and the GP front-ends' serve and train steps."""

from repro_torch.train.gp_step import attach_mesh, make_gp_serve_step, make_gp_train_step
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_compressed_dp_step, make_train_step

__all__ = ["attach_mesh", "make_gp_serve_step", "make_gp_train_step", "make_prefill_step", "make_decode_step",
           "make_train_step", "make_compressed_dp_step"]
