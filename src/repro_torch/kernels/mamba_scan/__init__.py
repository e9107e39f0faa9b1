from .ops import selective_scan  # noqa: F401
from .ref import selective_scan_ref  # noqa: F401
