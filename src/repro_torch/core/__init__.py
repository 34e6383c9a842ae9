"""Host-side model description for the port: ``ModelSpec``, per-block
parameter shapes and the paged-cache byte accounting."""
from repro_torch.core.model_config import ModelSpec, MoESpec, SSMSpec, XLSTMSpec

__all__ = ["ModelSpec", "MoESpec", "SSMSpec", "XLSTMSpec"]
