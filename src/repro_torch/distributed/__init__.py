"""Distribution over a mesh (port of ``repro.distributed``): the layout
rules (``sharding``) and the collectives over per-shard values
(``collectives``)."""
