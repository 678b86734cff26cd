from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model, get_config, list_archs
