"""AdamW and learning-rate schedules over a params dict
(``repro.optim``; its int8 gradient compression belongs to the LM side
and is not ported)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                    global_norm, tree_leaves, tree_map)
from .schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "tree_leaves", "tree_map", "cosine_schedule",
           "linear_warmup_cosine"]
