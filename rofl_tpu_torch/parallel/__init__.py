"""Device-mesh parallelism: ``mesh`` (the sharded data plane) and ``dryrun``
(a whole round over a client × param mesh)."""
