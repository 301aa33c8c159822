"""Fault tolerance of training (port of ``repro.ft``): the straggler
watchdog and elastic resharding (``ft.elastic``)."""
