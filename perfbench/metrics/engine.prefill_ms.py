"""``EngineStats.prefill_s`` over the window, a wave: the engine's own
prefill timer, which synchronises the device before reading the clock."""

UNIT, LAYER, MOVES, SOURCE = "ms", "engine", "call_p95_s", "program_span"


def read(r):
    return 1e3 * r.prefill_s / len(r.waves)
