"""95th percentile (nearest rank) of every frame's wall time in the
window: host clock around one ``render_asdr_image`` call and the
``torch.cuda.synchronize`` after it."""
from bench.metrics._stats import percentile


def read(obs):
    return 1e3 * percentile(obs["frame_s"], 95.0)
