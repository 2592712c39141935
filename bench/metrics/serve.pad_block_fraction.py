"""Share of the window's marched blocks that were padding, from the
engine's counters (serve/stats.py) over the window."""


def read(obs):
    c = obs["counters"]
    total = c["blocks_marched"] + c["pad_blocks"]
    return 100.0 * c["pad_blocks"] / total if total else None
