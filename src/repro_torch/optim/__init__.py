"""AdamW, learning-rate schedules and int8 gradient compression over a
params dict (``repro.optim``)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                    global_norm, tree_leaves, tree_map)
from .compress import (CHUNK, ErrorFeedback, compressed_psum, int8_compress,
                       int8_decompress)
from .schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "tree_leaves", "tree_map", "cosine_schedule",
           "linear_warmup_cosine", "CHUNK", "ErrorFeedback",
           "compressed_psum", "int8_compress", "int8_decompress"]
