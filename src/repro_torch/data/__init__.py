"""Deterministic, sharded, resumable token streams (counterpart of
``repro/data``)."""
