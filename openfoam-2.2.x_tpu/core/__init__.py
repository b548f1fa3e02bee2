from . import precision  # noqa: F401  (device precision policy)
from . import dimensions  # noqa: F401
from . import dictionary  # noqa: F401
