"""Span names of the port's own: the engine's phases inside
``engine.generate``, which the reference does not trace. ``names.py`` stays a
verbatim copy of the reference's catalog; a check of the port's spans takes
both catalogs (``names.SPAN_NAMES + port_names.SPAN_NAMES``).

Pure literals, like ``names.py``: a tool can read them without importing the
package.
"""

# the prefill of one generate call (attrs: batch, tokens, prefix)
SPAN_ENGINE_PREFILL = "engine.prefill"
# one decode step of the generate loop (attrs: step, active, graph)
SPAN_ENGINE_DECODE_STEP = "engine.decode_step"
# engine.decode_step's attribute: how the step ran, "eager", "replay" (of
# the engine's CUDA graph) or "capture" (captured into it, then replayed)
ATTR_DECODE_GRAPH = "graph"

SPAN_NAMES = (
    "engine.prefill",
    "engine.decode_step",
)
