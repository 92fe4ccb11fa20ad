#!/usr/bin/env python3
"""Where a warp of the banked-bag kernel spends its cycles, on one CUDA card.

    python3 tools/bag_phase_timing.py

Builds a copy of ``src/repro_torch/kernels/csrc/banked_bag.cu`` into
``build/phase_timing/`` with ``clock64()`` stamps at the kernel's phase
boundaries (one per warp, written by lane 0), and a second copy whose row
copies are removed (their addresses still computed). Runs both on the
serve shape's single-copy call (D = 32 fp32, 8 fields x 2,360,650 rows,
a random slot permutation, L2 flushed before each run) at 132 bags (one an
SM) and 512 bags (the serve batch), on uniform ids and on padding only, and
prints the median cycles per warp of each phase:

* resolve: the idx, bank and slot loads of a 256-entry segment and their
  slots written to shared memory;
* issue: the copies of the first ``stages`` ring stages;
* first wait: until stage 0's copies have landed;
* stream: the remaining stages' copies, waits and every stage's adds
  (with the cycles of every stage's wait and of its adds summed apart);

then the whole warp and the first start to the last end in ns
(``%globaltimer``). Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FIELDS, ROWS, L, D = 8, 2_360_650, 256, 32
STAMPS = 16                      # int64 per warp: 8 clock64, 8 globaltimer


def instrumented(src: str) -> str:
    """The kernel source with the stamps and a set_stamps() entry."""
    def at(anchor: str, text: str, after: bool = True) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"bag_phase_timing: anchor not found once in "
                             f"banked_bag.cu: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    at("namespace {\n",
       "__device__ long long* g_stamps;\n"
       "__device__ __forceinline__ long long gtime() {\n"
       "  long long t;\n"
       "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
       "  return t;\n}\n"
       "#define STAMP(i) if (lane == 0) { \\\n"
       f"  g_stamps[bag * {STAMPS} + (i)] = clock64(); \\\n"
       f"  g_stamps[bag * {STAMPS} + 8 + (i)] = gtime(); }}\n")
    at("  if (bag >= nb) return;                      // uniform across the "
       "warp\n", "  STAMP(0);\n  long long c_wait = 0, c_add = 0, c0_;\n")
    at("        resolved = sg;\n      }\n", "      STAMP(1);\n")
    at("          wait_pending(stages - 1);           // stage ta's copies "
       "landed\n", "          if (ta == 0) { STAMP(2); }\n"
       "          c0_ = clock64();\n", after=False)
    at("          wait_pending(stages - 1);           // stage ta's copies "
       "landed\n          __syncwarp();\n", "          if (ta == 0) { "
       "STAMP(3); }\n          c_wait += clock64() - c0_;\n"
       "          c0_ = clock64();\n")
    at("          __syncwarp();                       // buffer b free again\n",
       "          c_add += clock64() - c0_;\n")
    at("#pragma unroll\n    for (int k = 0; k < K; ++k) {\n      const int c = "
       "lane + kWarp * k;\n      if (c < cols) store(", "    STAMP(4);\n"
       f"    if (lane == 0) {{ g_stamps[bag * {STAMPS} + 5] = c_wait; "
       f"g_stamps[bag * {STAMPS} + 6] = c_add; }}\n", after=False)
    return src + ('\nextern "C" int set_stamps(void* p) {\n'
                  '  return cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n')


COPY = """              copy_unit<kVec>(dst0 + r[i] * kRowBytes + v,
                              live ? tpass + st[i] * stride + v : tbytes,
                              live);"""
NO_COPY = """              {
                unsigned char* d = dst0 + r[i] * kRowBytes + v;
                const unsigned char* sp = live ? tpass + st[i] * stride + v
                                               : tbytes;
                asm volatile("" :: "l"(d), "l"(sp));
              }"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bag_phase_timing: no CUDA card")
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as kb
    src = instrumented((_build.CSRC / "banked_bag.cu").read_text())
    if src.count(COPY) != 1:
        raise SystemExit("bag_phase_timing: the row copy was not found once")
    out_dir = ROOT / "build" / "phase_timing"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in (("kernel", src),
                       ("no row copies", src.replace(COPY, NO_COPY))):
        cu = out_dir / f"{name.replace(' ', '_')}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"bag_phase_timing: {name} did not build\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    V = FIELDS * ROWS
    table = torch.randn((V, D), generator=g, device=dev)
    slot = torch.randperm(V, generator=g, device=dev).to(torch.int32)
    bank = torch.zeros(V, dtype=torch.int32, device=dev)
    off = torch.arange(FIELDS, dtype=torch.int32, device=dev) * ROWS
    stamps = torch.zeros((4096, STAMPS), dtype=torch.int64, device=dev)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                           "clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    for name, lib in libs.items():
        fn = lib.banked_bag_forward
        fn.argtypes = [P, I, P, P, P, I, I, I, P, P, I, I, I, I, P, I, I, I]
        lib.set_stamps.argtypes = [P]
        if lib.set_stamps(stamps.data_ptr()) != 0:
            raise SystemExit("bag_phase_timing: set_stamps failed")
        for nb in (132, 512):
            for ids in ("uniform", "padding"):
                idx = torch.full((nb, L), -1, dtype=torch.int32, device=dev) \
                    if ids == "padding" else torch.randint(
                        0, ROWS, (nb, L), generator=g, device=dev,
                        dtype=torch.int32)
                res = torch.empty((nb, D), device=dev)
                geo = kb._geometry_args(table, nb, L)
                runs = []
                for rep in range(6):
                    scratch.zero_()
                    stamps.zero_()
                    err = fn(table.data_ptr(), 0, bank.data_ptr(),
                             slot.data_ptr(), off.data_ptr(), FIELDS, -1, 1,
                             idx.data_ptr(), res.data_ptr(), nb, L, D, 0,
                             torch.cuda.current_stream().cuda_stream, *geo)
                    if err:
                        raise SystemExit(f"bag_phase_timing: launch failed "
                                         f"({err})")
                    torch.cuda.synchronize()
                    if rep:                     # the first run warms up
                        runs.append(stamps[:nb].cpu())
                if name == "kernel" and not torch.equal(
                        res, kb.banked_bag_plain(table, bank, slot, off, -1,
                                                 idx)):
                    raise SystemExit("bag_phase_timing: kernel != plain")
                t = torch.stack(runs)           # (reps, nb, STAMPS)
                cyc = (t[..., 1:5] - t[..., 0:4]).float().median(1).values
                warp_cyc = (t[..., 4] - t[..., 0]).float().median(1).values
                warp_ns = (t[..., 12] - t[..., 8]).float().median(1).values
                span_ns = (t[..., 12].max(1).values
                           - t[..., 8].min(1).values).float()
                med = cyc.median(0).values.tolist()
                waits = t[..., 5].float().median(1).values.median()
                adds = t[..., 6].float().median(1).values.median()
                print(f"{name}, NB={nb}, {ids} ids: median cycles per warp "
                      f"resolve {med[0]:.0f}, issue {med[1]:.0f}, first wait "
                      f"{med[2]:.0f}, stream {med[3]:.0f} (all stages' "
                      f"waits {waits:.0f}, adds {adds:.0f}); warp "
                      f"{warp_cyc.median():.0f} cycles, "
                      f"{warp_ns.median():.0f} ns; first start to last end "
                      f"{span_ns.median():.0f} ns", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
