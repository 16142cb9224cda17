"""The paper's vision split: ResNet-18 on CIFAR-10 (5 clients), split
after the second norm layer, aux head = one FC; and a CPU-sized config
(same values as :mod:`repro.configs.resnet18_cifar`)."""
from repro_torch.models.cnn import CNNConfig


def full_config() -> CNNConfig:
    return CNNConfig(widths=(64, 128, 256, 512), blocks_per_stage=2,
                     classes=10, client_blocks=1)


def smoke_config() -> CNNConfig:
    return CNNConfig(widths=(8, 16), blocks_per_stage=1, classes=10,
                     client_blocks=1)
