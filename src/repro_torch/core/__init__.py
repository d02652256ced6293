"""The APC control plane: plan cache, templates, backends, agent loop."""
