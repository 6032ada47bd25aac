"""Can chip_smoke.py's teachers fail? Runs its textdiffuser2, distill, dpo
and trocr_small phases on one CUDA card as they are, then again with one
kernel's result broken at run time (a wrapper patched in this process;
the repository's files stay as they are), and prints each teacher's
readings against its bounds. Every broken run must fail its phase's check.

  python3 chip_smoke_mutations.py [plain] [dq0] [causal0] [docdq0] [dec0]
                                  [doc32z] [dec32z]

  plain    the four phases unchanged: each must pass
  dq0      #6's dq zeroed, the dpo phase
  causal0  #1 run without its causal mask, the dpo phase
  docdq0   #10's dq zeroed, the distill phase
  dec0     #13's output zeroed, the textdiffuser2 phase
  doc32z   #9's output zeroed at head_dim 32 only (the student's), the
           distill phase
  dec32z   #13's output zeroed at head_dim 32 only, the trocr_small phase

Exits 0 when every plain run passes and every broken run fails.
"""
import sys
import time
import traceback

import torch

import chip_smoke as cs


def main(runs: list) -> int:
    cs.phase_device()
    da, fa, _, pa, qm = cs.register_kernels()
    cs.phase_build()
    orig = {"fbwd": fa._flash_backward_cuda, "ffwd": fa._flash_forward_cuda,
            "dbwd": da._doc_backward_cuda, "dfwd": da._doc_forward_cuda,
            "dec": pa.decode_attention}

    def restore():
        fa._flash_backward_cuda = orig["fbwd"]
        fa._flash_forward_cuda = orig["ffwd"]
        da._doc_backward_cuda = orig["dbwd"]
        da._doc_forward_cuda = orig["dfwd"]
        pa.decode_attention = orig["dec"]

    def dq0():
        def f(*a, **k):
            dq, dk, dv, db = orig["fbwd"](*a, **k)
            return dq.zero_(), dk, dv, db
        fa._flash_backward_cuda = f

    def causal0():
        def f(q, k, v, bias, mask, q_offset, kv_len, causal, window):
            return orig["ffwd"](q, k, v, bias, mask, q_offset, kv_len, False,
                                window)
        fa._flash_forward_cuda = f

    def docdq0():
        def f(*a, **k):
            dq, dk, dv, ds = orig["dbwd"](*a, **k)
            return dq.zero_(), dk, dv, ds
        da._doc_backward_cuda = f

    def dec0():
        def f(*a, **k):
            return orig["dec"](*a, **k).zero_()
        pa.decode_attention = f

    def doc32z():
        def f(q, *a, **k):
            out = orig["dfwd"](q, *a, **k)
            return out.zero_() if q.shape[-1] == 32 else out
        da._doc_forward_cuda = f

    def dec32z():
        def f(qs, *a, **k):
            out = orig["dec"](qs, *a, **k)
            return out.zero_() if qs.shape[-1] == 32 else out
        pa.decode_attention = f

    table = {"plain": (None, ("td2", "distill", "dpo", "trocr_small")),
             "dq0": (dq0, ("dpo",)), "causal0": (causal0, ("dpo",)),
             "docdq0": (docdq0, ("distill",)), "dec0": (dec0, ("td2",)),
             "doc32z": (doc32z, ("distill",)),
             "dec32z": (dec32z, ("trocr_small",))}
    phases = {"td2": cs.phase_textdiffuser2, "distill": cs.phase_distill,
              "dpo": cs.phase_dpo,
              "trocr_small": lambda: cs.phase_trocr(qm, False, "trocr_small")}
    ok = True
    for run in runs or list(table):
        patch, keys = table[run]
        for key in keys:
            restore()
            if patch:
                patch()
            t0 = time.time()
            try:
                phases[key]()
                print(f"[mutations] {run} {key}: passed, "
                      f"{time.time() - t0:.1f} s", flush=True)
                ok = ok and patch is None
            except AssertionError as e:
                print(f"[mutations] {run} {key}: failed, "
                      f"{time.time() - t0:.1f} s: {e}", flush=True)
                if patch is None:
                    ok = False
                    traceback.print_exc()
            torch.cuda.empty_cache()
    restore()
    print("[mutations] " + ("as expected" if ok else "NOT as expected"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
