"""Host milliseconds a delivered frame of the scene store's stores: the
``scenecache.store`` spans (scenecache/store.py ``SceneBlockCache.store``:
a marched block's outputs filed and whatever its budget evicts) of the
traced window."""
from bench.metrics._spans import ms_a_frame


def read(obs, spans=None):
    return ms_a_frame(obs, "scenecache.store", spans)
