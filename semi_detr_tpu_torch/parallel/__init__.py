"""Data parallelism over torch.distributed (`dist`), the counterpart of
`semi_detr_tpu/parallel`."""
