"""Frames the server delivered over the whole measured window (host
clock)."""


def read(obs):
    return obs["frames"] / obs["window_s"]
