"""Model zoo of the port: DeepLabV3+ on MobileNetV2 (full and lite heads)."""
