"""Data parallelism over torch.distributed and its (data, model) mesh
(`dist`), and FSDP / tensor parallelism of the train state (`sharding`):
the counterpart of `semi_detr_tpu/parallel`."""
