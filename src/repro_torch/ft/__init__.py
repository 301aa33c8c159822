"""Fault tolerance of training (port of ``repro.ft``): the straggler
watchdog. ``ft.elastic`` comes with the mesh slice."""
