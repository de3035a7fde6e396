"""lanemapping_tpu_torch — the PyTorch/CUDA port of ``lanemapping_tpu`` for one
NVIDIA H100.

It mirrors the JAX package's module paths and names, imports ``torch`` and
never ``jax`` nor ``lanemapping_tpu`` (what it needs of the JAX package's
NumPy-only modules it keeps as its own copies), and runs its entry points on
the card (``device="cuda"``) unless the caller asks for the CPU.  The TPU
kernel of the ported paths (BEV binning) is two hand-written CUDA kernels
on a shared band bucketing (``csrc/bin_bands.cuh``), built with ``nvcc`` at
first use: K1 (``csrc/bev_bin.cu``, the LAS rasterizer) and K1z
(``csrc/voxel_bin.cu``, the LiDAR z-fold voxelizer).
"""

from .config.config import Config, ConfigDict  # noqa: F401
from .registry import (BACKBONE, DATASETS, HEADS, NET, PCENCODER,  # noqa: F401
                       build_backbone, build_dataset, build_from_cfg,
                       build_heads, build_net, build_pcencoder)

# importing model/data modules populates the registries
from .models import (column_head, legacy, lidar_encoder,  # noqa: F401,E402
                     nets, resnet_fpn, row_head, vit)
from .data import las_tiles, laserlane  # noqa: F401,E402
from .models.nets import build_model  # noqa: F401,E402
from .api import LaneMapper  # noqa: F401,E402

__version__ = "0.1.0"
