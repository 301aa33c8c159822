"""Request routing across engine replicas.

Port of ``repro.serving.mesh`` without the mesh: ``router.py`` spreads
requests across ``Engine`` replicas by free-page pressure, migrates
waiting requests off saturated replicas and, with ``FTConfig``,
quarantines dead replicas and rescues their work. In the port every
replica lives on the one card. ``shard.py`` (the layout of pools and
params on a mesh's ``model`` axis) comes with the mesh slice.
"""
from .router import Router, RouterConfig                 # noqa: F401
