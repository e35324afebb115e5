"""Data: image files, the COCO reader, augmentations, the semi-balance
sampler, bucketed batches, synthetic sets and COCO mAP."""
