"""svt_av1_psy_tpu — an AV1 encoder with the SVT-AV1-PSY capability set.

A from-scratch JAX/XLA + C re-design (NOT a port) of the capability set of
`gianni-rosato/svt-av1-psy` (SVT-AV1 v2.3.0-A + psychovisual features).

Architecture (two-phase, see SURVEY.md §7):
  - The reference's 16-thread SRM pipeline (ref: Source/Lib/Codec/sys_resource_manager.c)
    becomes a host-orchestrated pipeline of jitted device search programs over
    batched superblock tensors (XLA compiles them for the GPU) feeding native C
    commit walks on the host.
  - The reference's per-ISA SIMD kernels (ref: Source/Lib/ASM_*) become dense
    JAX programs over SB batches (ops/jax_backend.py) and native C (native/).
  - Tile columns can shard over a jax.sharding.Mesh (checked as a CPU dry run).

Public API mirrors Source/API/EbSvtAv1Enc.h:1101-1217:
  Encoder(config) ≈ svt_av1_enc_init_handle + set_parameter + init
  Encoder.send_picture / get_packet / get_recon / flush ≈ the C entry points.
"""

__version__ = "0.1.0"
__version_tag__ = "PSY"

from svt_av1_psy_tpu.config import EncoderConfig, parse_parameter, validate_config

__all__ = [
    "EncoderConfig",
    "parse_parameter",
    "validate_config",
    "__version__",
]
