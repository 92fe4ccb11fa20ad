"""Device ms a bulk step in the MLPs' matrix products (the GEMM kernels
that ``torch.matmul`` launches), from the trace."""

GEMM = r"gemm|GEMM|cutlass|xmma|sm90_|ampere_"
OWN = r"banked_bag|dot_interaction|dot_tiled|ct_scatter"


def read(ctx):
    r = ctx.run
    if r.mode != "bulk" or ctx.summary is None:
        return None
    t = ctx.summary.device_s(GEMM, exclude=OWN)
    return t / r.steps * 1e3 if t > 0 else None
