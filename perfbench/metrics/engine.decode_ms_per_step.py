"""``EngineStats.decode_s`` over the window, a decode step (a step decodes
every row of a wave by one token)."""

UNIT, LAYER, MOVES, SOURCE = "ms", "engine", "calls_per_s", "program_span"


def read(r):
    if not r.decode_steps:
        return None
    return 1e3 * r.decode_s / r.decode_steps
