from repro_torch.distributed.axes import (axis_env, constrain, default_mapping,
                                          logical_to_spec)

__all__ = ["axis_env", "constrain", "default_mapping", "logical_to_spec"]
