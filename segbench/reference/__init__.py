"""Plain PyTorch reference of every cell: DeepLabV3+ (MobileNetV2, Xception-65),
its augmentation, loss and SGD steps, and evaluation. It imports
nothing of the program."""
