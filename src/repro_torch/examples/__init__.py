"""The port's twins of the reference's example drivers (``examples/``), each
an entry point of its own:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.distributed_cache_demo [--device cpu]
    python -m repro_torch.examples.serve_agent [--n 30] [--env tabmwp] [--full] [--device cpu]
    python -m repro_torch.examples.train_small [--arch qwen2.5-3b] [--steps 200] [--device cpu]

Each takes the reference script's flags plus ``--device`` (CUDA unless
``cpu`` is asked for; without a card the default raises) and prints the
reference's lines. ``quickstart`` and ``distributed_cache_demo`` run the
control plane on the host only; ``serve_agent`` serves on the port's torch
engines and ``train_small`` trains on the port's trainer.
"""
