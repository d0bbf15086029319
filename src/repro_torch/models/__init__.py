from repro_torch.models.lm import Model, build_model

__all__ = ["Model", "build_model"]
