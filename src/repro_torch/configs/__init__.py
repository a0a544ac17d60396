"""Config registry (copy of `repro.configs`): importing this package registers
the architectures the port runs so far."""
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
