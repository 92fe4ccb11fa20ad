from repro_torch.configs.registry import ARCHS, ArchSpec, get_arch

__all__ = ["ARCHS", "ArchSpec", "get_arch"]
