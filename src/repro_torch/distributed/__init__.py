"""Fault-tolerant training supervision (the single-process part of
``repro.distributed``)."""
