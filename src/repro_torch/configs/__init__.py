from repro_torch.configs.registry import ARCHS, ArchSpec, get_arch, list_archs

__all__ = ["ARCHS", "ArchSpec", "get_arch", "list_archs"]
