"""Multi-device execution: mesh construction, halo-exchanged domain
decomposition (the parallelism the reference only stubbed out —
d2q9-bgk.c:208 "Collate data from ranks here"), and data-parallel deck
batching (the device-mesh form of its Slurm array job)."""
