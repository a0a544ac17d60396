"""Config registry (copy of `repro.configs`): importing this package registers
all architectures."""
from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    SHAPES_BY_NAME,
    ArchConfig,
    LayerSpec,
    ShapeSpec,
    get_arch,
    list_archs,
    reduced,
    register,
)

# Assigned architectures (register on import).
from repro_torch.configs import jamba_1_5_large_398b  # noqa: F401
from repro_torch.configs import xlstm_1_3b  # noqa: F401
from repro_torch.configs import qwen3_8b  # noqa: F401
from repro_torch.configs import gemma3_1b  # noqa: F401
from repro_torch.configs import gemma3_4b  # noqa: F401
from repro_torch.configs import h2o_danube_1_8b  # noqa: F401
from repro_torch.configs import grok_1_314b  # noqa: F401
from repro_torch.configs import qwen3_moe_30b_a3b  # noqa: F401
from repro_torch.configs import qwen2_vl_7b  # noqa: F401
from repro_torch.configs import whisper_medium  # noqa: F401

# Paper's own models (Table 3).
from repro_torch.configs import paper_models  # noqa: F401

ASSIGNED_ARCHS = (
    "jamba-1.5-large-398b",
    "xlstm-1.3b",
    "qwen3-8b",
    "gemma3-1b",
    "gemma3-4b",
    "h2o-danube-1.8b",
    "qwen2-vl-7b",
    "whisper-medium",
    "grok-1-314b",
    "qwen3-moe-30b-a3b",
)
