"""The serving stacks (``repro.serve``): the LM slot engine (``engine``)
and the render serving engine with its admission, pool, executor,
scheduler and stats layers."""
from .engine import Request, ServeConfig, ServingEngine  # noqa: F401
from .executor import SyncExecutor, ThreadedExecutor, make_executor  # noqa: F401
from .render_engine import (RenderRequest, RenderServeConfig,  # noqa: F401
                            RenderServingEngine)
