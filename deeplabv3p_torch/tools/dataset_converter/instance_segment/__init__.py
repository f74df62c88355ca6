"""Instance-segmentation dataset converters (reference
tools/dataset_converter/instance_segment/), pycocotools-free on
`coco_mask`: copies of the JAX package's `tools/dataset_converter/
instance_segment/` that import the port instead."""
