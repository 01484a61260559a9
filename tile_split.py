"""Where a step of the PDHG tile kernels goes, and an A/B of two trees.

    python3 tile_split.py time TAG     # device ms of the tile rounds
    python3 tile_split.py split        # the step split by part

Run on the machine with the card, from the root of a tree (a checkout, or
a `git archive` of another commit with this file copied in); the
instances are found as chip_smoke.py finds them (SQLP_TPU_SPINPUT).

`time` prints the device time (chip_smoke.device_ms) of one 80-step round
and of one step of the tile kernel the plan picks, Halpern and average,
at ssn's rungs, on chip_smoke._digest_inputs' fixed inputs, for the tree
it runs in; run it in two trees in turns (A, B, B, A) in one call to
compare them on one card.

`split` compiles copies of this tree's csrc/pdhg_tile.cuh with parts of
the step left out (the primal product, the dual product, both, the dual
update) into libraries of their own, under build/tile_split/, and times
each at ssn B = 256, 1024, 4096 (float32, C = 4) and 256 (float64,
C = 8): the per-step time is (80 steps - 1 step) / 79, and a part's
share is the difference between two builds. The parts are found by the
source lines that launch them, for this design and for the first one
(commit 2fce5b6); outputs of the builds with parts left out are
meaningless, only their times count. It prints each build's registers
and spills (-Xptxas -v).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

# (text, macro): the launch of each part, wrapped in #ifndef macro
_PARTS = {
    "first": [
        ("""        if constexpr (sizeof(T) == 4) {
          tile_product_fma<true>(Lf, Ks + nt0 * nit * 64, nit * 64, 64,
                                 njt - nt0, nit, lane, acc);
        } else {
          tile_product<true>(Lf, Ks + nt0 * nit * 64, nit * 64, 64,
                             njt - nt0, nit, lane, acc);
        }""", "SPLIT_NO_PRIMAL"),
        ("""        if constexpr (sizeof(T) == 4) {
          tile_product_fma<false>(Yb, Ks + it0 * 64, 64, nit * 64, nit - it0,
                                  njt, lane, acc);
        } else {
          tile_product<false>(Yb, Ks + it0 * 64, 64, nit * 64, nit - it0,
                              njt, lane, acc);
        }""", "SPLIT_NO_DUAL"),
    ],
    "now": [
        ("""            fma_rows<RR, true>(Lf + p * lm, G * lm, Ks + jb * sj + 8 * hc,
                               si, nit, acc);""", "SPLIT_NO_PRIMAL"),
        ("""          tile_product<true>(Lf, Ks + nt0 * sj, sj, si, njt - nt0, nit,
                             lane, acc);""", "SPLIT_NO_PRIMAL"),
        ("""            fma_rows<RR, false>(Yb + p * ln, G * ln, Ks + ib * si + 4 * h,
                                sj, njt, acc);""", "SPLIT_NO_DUAL"),
        ("""          tile_product<false>(Yb, Ks + it0 * si, si, sj, nit - it0, njt,
                              lane, acc);""", "SPLIT_NO_DUAL"),
    ],
}
# the dual update's loop, from its first line to the line after it
_UPDATE = {
    "first": ("""      for (int idx = tid; idx < TM * mc; idx += kThreads) {
        const int r = item_row(idx, nb);""",
              """      // also keeps every CTA resident until the others' stores have landed"""),
    "now": ("""      for (int idx = tid; idx < tm * ng; idx += kThreads) {
        const Own o = idx == tid ? o0 : own(idx);""",
            """      // also keeps every CTA resident until the others' stores have landed"""),
}
_BUILDS = {"all": [], "no primal": ["-DSPLIT_NO_PRIMAL"],
           "no dual": ["-DSPLIT_NO_DUAL"],
           "no products": ["-DSPLIT_NO_PRIMAL", "-DSPLIT_NO_DUAL"],
           "no update": ["-DSPLIT_NO_UPDATE"],
           "no products, no update": ["-DSPLIT_NO_PRIMAL", "-DSPLIT_NO_DUAL",
                                      "-DSPLIT_NO_UPDATE"]}


def _patched(src: str) -> str:
    """The header with every part of the step wrapped in its macro."""
    design = "now" if "fma_rows" in src else "first"
    for text, macro in _PARTS[design]:
        if src.count(text) != 1:
            raise SystemExit(f"tile_split: part {macro} not found once in "
                             f"csrc/pdhg_tile.cuh; update _PARTS")
        src = src.replace(text, f"#ifndef {macro}\n{text}\n#endif")
    first, after = _UPDATE[design]
    if src.count(first) != 1 or src.count(after) != 1:
        raise SystemExit("tile_split: the dual update not found; update "
                         "_UPDATE")
    src = src.replace(first, "#ifndef SPLIT_NO_UPDATE\n" + first)
    return src.replace(after, "#endif\n" + after)


def split() -> None:
    import torch
    import chip_smoke as cs
    from sqlp_tpu_torch.ops.cuda import build, pdhg_kernel as pk

    csrc = os.path.join("sqlp_tpu_torch", "csrc")
    out = os.path.join("build", "tile_split")
    os.makedirs(out, exist_ok=True)
    for name in ("pdhg_common.cuh", "pdhg_halpern_tile.cu"):
        with open(os.path.join(csrc, name)) as f, \
                open(os.path.join(out, name), "w") as g:
            g.write(f.read())
    with open(os.path.join(csrc, "pdhg_tile.cuh")) as f, \
            open(os.path.join(out, "pdhg_tile.cuh"), "w") as g:
        g.write(_patched(f.read()))
    nvcc = build._nvcc()
    procs = {}
    for i, (label, flags) in enumerate(_BUILDS.items()):
        lib = os.path.abspath(os.path.join(out, f"lib{i}.so"))
        cmd = [nvcc, *build._FLAGS, *flags, "-shared", "-Xptxas", "-v",
               "-o", lib, os.path.join(out, "pdhg_halpern_tile.cu")]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"tile_split: nvcc failed for {label}:\n{text}")
        regs = [line.split(":")[-1].strip() for line in text.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[split] build '{label}': {regs}", flush=True)
        libs[label] = ctypes.CDLL(lib)
    head = build._SIGNATURES["pdhg_halpern_tile"]
    takes_tm = head[2] is ctypes.c_int      # the first design has no tm
    for B, dname, C in ((256, "float32", 4), (1024, "float32", 4),
                        (4096, "float32", 4), (256, "float64", 8)):
        args = cs._digest_inputs("ssn", B, dname, False)
        m, n = args[0].shape
        it = args[0].element_size()
        per_wave = pk._tile_clusters_per_wave(C, m, n, it, "halpern")
        rows = getattr(pk, "_tile_rows", None)
        tm = rows(B, C, m, n, it, "halpern") if rows else 16
        lead = (C, min(-(-B // tm), per_wave)) + ((tm,) if takes_tm else ())
        outs = [torch.empty_like(args[i]) for i in (8, 9, 8, 9)]
        ptrs = [a.data_ptr() for a in args]
        for label, lib in libs.items():
            fn = getattr(lib, f"pdhg_halpern_tile_f{8 * it}")
            fn.argtypes = head

            def call(k, fn=fn):
                code = fn(*lead, ptrs[0], ptrs[1], 0, *ptrs[2:],
                          *[o.data_ptr() for o in outs], B, m, n, k,
                          torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise SystemExit(f"tile_split: launch failed ({code})")
            t80 = cs.device_ms(lambda: call(80), 5)
            t1 = cs.device_ms(lambda: call(1), 5)
            print(f"[split] ssn B={B} {dname} C={C} tm={tm} {label}: "
                  f"80 steps {t80:.4f} ms, 1 step {t1:.4f} ms, per step "
                  f"{1e3 * (t80 - t1) / 79:.2f} us", flush=True)


def time_rounds(tag: str) -> None:
    import chip_smoke as cs
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk

    for scheme, B, dname in (
            ("halpern", 256, "float32"), ("halpern", 512, "float32"),
            ("halpern", 768, "float32"), ("halpern", 1024, "float32"),
            ("halpern", 4096, "float32"), ("halpern", 8192, "float32"),
            ("average", 256, "float32"), ("average", 1024, "float32"),
            ("average", 4096, "float32"), ("halpern", 256, "float64"),
            ("average", 256, "float64"), ("halpern", 1024, "float64")):
        args = cs._digest_inputs("ssn", B, dname, False)
        args = args[:cs._PDHG_ARGS[scheme]]
        kernel = getattr(pk, f"pdhg_{scheme}_round")
        m, n = args[0].shape
        it = args[0].element_size()
        plan = ("tile",) + pk._tile_shape(B, m, n, it, scheme)
        reps = 3 if B >= 1024 else 10
        ms = cs.device_ms(lambda: kernel(*args, 80, plan=plan), reps)
        ms1 = cs.device_ms(lambda: kernel(*args, 1, plan=plan), reps)
        print(f"[time {tag}] {scheme} ssn B={B} {dname} {plan}: "
              f"kernel_ms={ms:.4f} 1step_ms={ms1:.4f} "
              f"per_step_us={1e3 * (ms - ms1) / 79:.2f}", flush=True)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("tile_split: needs a CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "time":
        time_rounds(sys.argv[2])
    elif len(sys.argv) == 2 and sys.argv[1] == "split":
        split()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
