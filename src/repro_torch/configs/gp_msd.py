"""The paper's own workload: tiled GP regression on mass-spring-damper data.

The five GP shapes of the JAX package's ``configs/gp_msd.py``: the paper's
single-device cells (n up to 32768; Figs. 3, 4, 6, 7 at their best tile
sizes) and the distributed cells that motivate the multi-device extension.
The data come from :func:`repro_torch.data.msd.make_dataset`.
"""

from repro_torch.configs.base import GPShapeConfig

# paper-scale single-device cells; 32 tiles a dimension at n = 32768
GP_PAPER_32K = GPShapeConfig("gp_32k", n_train=32768, n_test=32768, tile_size=1024)
GP_PAPER_16K = GPShapeConfig("gp_16k", n_train=16384, n_test=16384, tile_size=512)

# distributed cells: M = 16 x P tile rows keep the block-cyclic grid balanced
# and the split panel solve active (core/distributed.py)
GP_DIST_32K = GPShapeConfig("gp_dist_32k", n_train=32768, n_test=16384, tile_size=128)
GP_DIST_256K = GPShapeConfig("gp_256k", n_train=262144, n_test=16384, tile_size=1024)
GP_DIST_512K = GPShapeConfig("gp_512k", n_train=524288, n_test=32768, tile_size=1024)

ALL_GP_SHAPES = (GP_PAPER_16K, GP_PAPER_32K, GP_DIST_32K, GP_DIST_256K, GP_DIST_512K)
