"""Host milliseconds a delivered frame of the scene store's block keys:
the ``scenecache.keys`` spans (serve/pool.py ``add_slot``: each block of
an admitted slot hashed on the host, with the host copy of the slot's
sorted rays) of the traced window."""
from bench.metrics._spans import ms_a_frame


def read(obs, spans=None):
    return ms_a_frame(obs, "scenecache.keys", spans)
