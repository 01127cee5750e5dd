"""``rscm._lib.magicc`` — MAGICC component builders."""

from ..magicc import *  # noqa: F401,F403
from ..magicc import __all__  # noqa: F401
