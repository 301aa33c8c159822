"""Serving across engine replicas and mesh positions (port of
``repro.serving.mesh``): ``router.py`` spreads requests across
``Engine`` replicas by free-page pressure, migrates waiting requests off
saturated replicas and, with ``FTConfig``, quarantines dead replicas
and rescues their work; ``shard.py`` lays an engine's pools and params
out on a mesh's ``model`` axis (``Engine(mesh=...)``).
"""
from .router import Router, RouterConfig                 # noqa: F401
