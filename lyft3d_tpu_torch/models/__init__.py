"""Model families (torch ``nn.Module``s; NHWC at the model boundary).

Registry-based construction with the JAX package's names.
"""

from lyft3d_tpu_torch.models.registry import build_model, list_models, register_model

__all__ = ["build_model", "register_model", "list_models"]
