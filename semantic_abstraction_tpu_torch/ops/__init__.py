"""Device ops of the port. The kernel wrappers live in their own modules
(``ops.fused_mha``) and are imported where they are used."""
from .sampling import resize_matrix

__all__ = ["resize_matrix"]
