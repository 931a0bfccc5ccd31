"""Persistence: checkpoint/resume (`checkpoint`), animation export
(`animation`), the native framepack writer (`native`) and 1D sample-set
JSON (`sampler_json`). Import the submodules themselves; this package
imports nothing at load."""
