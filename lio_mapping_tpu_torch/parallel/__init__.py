"""The distributed estimator over ``torch.distributed``: one process per
rank (``multihost``), the full per-sweep step on a 1-D mesh (``lio_dist``),
the map-sharded ring KNN (``map_sharded``), the sharded window solve
(``sharded_ba``) and the isolated BA core (``distributed``)."""
