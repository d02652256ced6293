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
# engine.prefill's attributes of a model with Mamba-2 layers (zamba2,
# nemotron_h): its Mamba-2 and attention layers, and the bytes of SSM state
# and conv carries its cache holds (``EngineStats.ssm_state_bytes``)
ATTR_MAMBA_LAYERS = "mamba_layers"
ATTR_ATTENTION_LAYERS = "attention_layers"
ATTR_SSM_STATE_BYTES = "ssm_state_bytes"
# one Mamba-2 mixer of a nemotron_h forward (a prefill: the decode step's
# mixers run inside the engine's CUDA graph); attrs: layer
SPAN_MODEL_MAMBA = "model.mamba"

SPAN_NAMES = (
    "engine.prefill",
    "engine.decode_step",
    "model.mamba",
)
