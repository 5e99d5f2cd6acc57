"""repro_torch.core — the SSA/HA-SSA annealer (model, schedule, engine, anneal()).

Submodules are imported by their callers; this package file imports
nothing, so loading a numpy-only module never pulls in the engine.
"""
