"""Where one call of the MAS kernel spends its time on the card.

    python -m tts_arabic_torch.tools.mas_split [--source path/to/mas.cu]

Builds a copy of a MAS source (by default the package's `csrc/mas.cu`)
with `clock64()` and `%globaltimer` stamps, apart from the kernels'
library, and runs it at training shapes. A stamp goes before every line
of the kernel that starts a section with a `// ---- <name>` comment, and
after the last one-hot store of a source whose kernel ends with
`o[j] = 1.f;  // row 0`; lane 0 of each warp that passes a stamp records
it (the last writer wins). For each shape it prints, averaged over the
batch rows (one block each), every stamp's offset from the first in
cycles and in microseconds at the clock the stamps show, then the device
time (CUDA events) of the stamped kernel, of the wrapper's `torch.zeros`
output clear where the source needs a zeroed output, and, for the
package's own source, of the whole `ops.mas.mas_fused` call the training
step makes.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import pathlib
import re
import subprocess

import torch

from ..ops import build

MAX_B = 64
# [B, T_mel, T_txt]: the batch shapes of chip_smoke.py's training run
SHAPES = ((10, 960, 144), (10, 896, 128), (10, 768, 112), (10, 640, 96))
STAMP_DEFS = r"""
__device__ long long mas_stamps[%d * 32];
#define MAS_STAMP(k) do { if ((threadIdx.x & 31) == 0) {                 \
    unsigned long long g_;                                                \
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g_));             \
    mas_stamps[blockIdx.x * 32 + 2 * (k)] = clock64();                    \
    mas_stamps[blockIdx.x * 32 + 2 * (k) + 1] = (long long)g_; } } while (0)
extern "C" int mas_read_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, mas_stamps, sizeof(mas_stamps));
}
""" % MAX_B


def stamped(src: str) -> tuple[str, list[str]]:
    """The source with stamps inserted, and the stamps' labels."""
    out, labels = [], []
    for ln in src.splitlines():
        m = re.match(r"\s*// ---- (\w[\w ,/()-]*?)\s*-*$", ln)
        if m:
            out.append(f"MAS_STAMP({len(labels)});")
            labels.append(m.group(1))
        out.append(ln)
        if re.search(r"o\[j\] = 1\.f;\s*// row 0", ln):
            out.append(f"MAS_STAMP({len(labels)});")
            labels.append("end")
        if ln.startswith("#include <stdint.h>"):
            out.append(STAMP_DEFS)
    if not 2 <= len(labels) <= 16:
        raise ValueError(f"stamp anchors found: {labels}")
    return "\n".join(out) + "\n", labels


def build_stamped(source: pathlib.Path) -> tuple[ctypes.CDLL, list[str]]:
    text, labels = stamped(source.read_text())
    h = hashlib.sha256((" ".join(build.NVCC_FLAGS) + text).encode())
    out = build.BUILD_DIR / f"libmas_stamped_{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = out.with_suffix(".cu")
        cu.write_text(text)
        res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                              "-o", str(out), str(cu)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mas_forward.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.mas_forward.restype = i
    lib.mas_read_stamps.argtypes = [p]
    lib.mas_read_stamps.restype = i
    return lib, labels


def inputs(shape, gen):
    """Log-softmaxed scores; row 0 at full size, the others with about 7
    frames a symbol, as the training corpus has them."""
    B, T_mel, T_txt = shape
    log_attn = torch.log_softmax(3.0 * torch.randn(
        shape, generator=gen, device="cuda"), dim=-1)
    in_lens = torch.randint(max(1, T_txt * 3 // 5), T_txt + 1, (B,),
                            generator=gen, device="cuda")
    out_lens = torch.clamp(7 * in_lens + torch.randint(
        -20, 21, (B,), generator=gen, device="cuda"), 1, T_mel)
    in_lens[0], out_lens[0] = T_txt, T_mel
    return log_attn, in_lens.to(torch.int32), out_lens.to(torch.int32)


def cuda_us(fn, reps: int = 20) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def split(lib, labels, shape, gen, own: bool) -> None:
    from ..ops import mas as mas_ops
    B, T_mel, T_txt = shape
    log_attn, in_lens, out_lens = inputs(shape, gen)
    scratch = getattr(lib, "mas_scratch_words", None)
    if scratch is None:             # one word per lane per frame
        words, zeroed = 32, True
    else:
        scratch.argtypes = [ctypes.c_int] * 2
        scratch.restype = ctypes.c_int
        words, zeroed = max(scratch(T_mel, T_txt), 1), False
    out = torch.zeros_like(log_attn)
    bits = torch.empty((B, T_mel, words), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.mas_forward(log_attn.data_ptr(), in_lens.data_ptr(),
                              out_lens.data_ptr(), out.data_ptr(),
                              bits.data_ptr(), B, T_mel, T_txt, stream)
        if err:
            raise RuntimeError(f"stamped kernel: cudaError {err}")

    kernel_us = cuda_us(run)
    if zeroed:
        out.zero_()
    run()
    torch.cuda.synchronize()
    if not torch.equal(out, mas_ops.mas_plain(log_attn, in_lens, out_lens)):
        raise AssertionError(f"stamped kernel differs from plain at {shape}")
    raw = (ctypes.c_longlong * (MAX_B * 32))()
    if lib.mas_read_stamps(ctypes.addressof(raw)):
        raise RuntimeError("reading the stamps failed")
    st = torch.tensor(list(raw), dtype=torch.float64).view(MAX_B, 16, 2)[:B]
    n = len(labels)
    cyc = st[:, :n, 0] - st[:, :1, 0]
    ns = st[:, n - 1, 1] - st[:, 0, 1]
    ghz = float((cyc[:, n - 1] / ns).median())
    clear_us = cuda_us(lambda: torch.zeros_like(log_attn)) if zeroed else 0.0
    call = "mas_fused not timed (another source)"
    if own:
        call_us = cuda_us(lambda: mas_ops.mas_fused(log_attn, in_lens,
                                                    out_lens))
        call = f"whole mas_fused call {call_us:.2f} us"
    print(f"[{B}, {T_mel}, {T_txt}] in_lens {in_lens.tolist()} out_lens "
          f"{out_lens.tolist()}; SM clock from the stamps {ghz:.3f} GHz")
    for k, label in enumerate(labels):
        mean, top = float(cyc[:, k].mean()), float(cyc[:, k].max())
        print(f"    stamp {k} {label:28} at {mean:>10.0f} cycles = "
              f"{mean / ghz / 1e3:>8.2f} us (mean over rows; max "
              f"{top / ghz / 1e3:.2f} us)")
    frames = float(out_lens.float().mean())
    print(f"    stamped kernel {kernel_us:.2f} us (events, 20 launches); "
          f"output clear (torch.zeros_like) {clear_us:.2f} us; {call}; "
          f"mean out_len {frames:.0f} "
          f"frames, whole span {float(cyc[:, n - 1].mean()) / frames:.1f} "
          "cycles a frame")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=pathlib.Path,
                    default=build.CSRC / "mas.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mas_split needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    lib, labels = build_stamped(args.source)
    print(f"{args.source}: stamps {labels} | {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        split(lib, labels, shape, gen,
              args.source.resolve() == (build.CSRC / "mas.cu").resolve())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
