"""The render serving stack (``repro.serve``, render side): the pooled
engine, its admission, pool, executor, scheduler and stats layers.  The
LM ``ServeConfig`` / ``ServingEngine`` are not ported yet."""
from .executor import SyncExecutor, ThreadedExecutor, make_executor  # noqa: F401
from .render_engine import (RenderRequest, RenderServeConfig,  # noqa: F401
                            RenderServingEngine)
