"""Device mesh, sharding rules, ring attention, sequence and pipeline
parallelism (port of unilm_tpu/parallel/) over `torch.distributed`."""
