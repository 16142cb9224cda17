"""K2 and K4 at the shapes of PERF.md's kernel table, timed from two
source trees on one card in turns A, B, B, A: for example a parent
commit unpacked with ``git archive`` (A) against the working tree (B).

    python3 tools/k2_k4_ab.py A_SRC B_SRC

Each turn is a process that imports ``repro_torch`` from its tree,
builds that tree's kernels and times each case with CUDA events (100
warm-up launches, then the mean of 100); the script prints the card's
name and power limit, each turn's times, and per case the mean of A's
two turns, of B's two and B / A.  Needs a card."""
import json
import os
import subprocess
import sys

# (kernel, dtype, M, K, N): gpt2-small's MLP up projection in bf16 and
# ResNet-18's first block conv over im2col patches in f32
CASES = (("K2", "bfloat16", 1024, 768, 3072), ("K2", "float32", 65536, 576,
                                                64),
         ("K4", "bfloat16", 1024, 768, 3072), ("K4", "float32", 65536, 576,
                                                64))
REPS, WARMUP = 100, 100


def worker(src):
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import zo_matmul as ZM
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda", 0)
    out = {}
    for kern, dt, M, K, N in CASES:
        g = torch.Generator(device=dev).manual_seed(0)
        dtype = getattr(torch, dt)
        xa, xb = (torch.randn((M, K), generator=g, device=dev).to(dtype)
                  for _ in "ab")
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(
            dtype)
        if kern == "K2":
            def fn():
                ZM.zo_dual_matmul(xa, xb, w, 3, 0.0, 1e-3)
        else:
            def fn():
                ZM.zo_matmul(xa, w, 3, 1e-3)
        for _ in range(WARMUP):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[f"{kern} {dt} {M} x {K}x{N}"] = start.elapsed_time(end) / REPS
    print("AB " + json.dumps(out), flush=True)


def main(a_src, b_src):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    turns = []
    for tag, src in (("A", a_src), ("B", b_src), ("B", b_src),
                     ("A", a_src)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", os.path.abspath(src)],
                             capture_output=True, text=True, check=True,
                             timeout=900).stdout
        line = [ln for ln in out.splitlines() if ln.startswith("AB ")][-1]
        turns.append((tag, json.loads(line[3:])))
        print(tag, turns[-1][1], flush=True)
    for case in turns[0][1]:
        a = sum(t[case] for tag, t in turns if tag == "A") / 2
        b = sum(t[case] for tag, t in turns if tag == "B") / 2
        print(f"{case}: A {a:.5f} ms, B {b:.5f} ms, B / A {b / a:.4f}",
              flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        main(sys.argv[1], sys.argv[2])
