from .registry import Arch, FAMILY_MODULES  # noqa: F401
from .spec import ModelConfig  # noqa: F401
