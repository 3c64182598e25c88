"""The document classifiers: ViT, SegFormer (MiT), ConvNeXt V2 and ResNet
(port of ``karanta_tpu/models/classifier``)."""
