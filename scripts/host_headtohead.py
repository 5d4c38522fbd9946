"""Reproducible host-path head-to-heads vs the reference binary.

Covers the rows of README's host table that round-4 VERDICT flagged as
losses: -merge, -genotypeCompare, -imputeMissing, -phase, -paint, and the
referenceImpute end-to-end.  Each subcommand generates its deterministic
fixture (once, cached in WORKDIR), runs both binaries with identical
commands, byte-compares outputs and prints per-run wall times.

The reference binary is built from /root/reference with the htslib stub
(same recipe as tests/test_crosscheck.py) into WORKDIR/refbuild.

Usage:
  python scripts/host_headtohead.py [merge|gtcompare|imputemissing|phase|
                                     paint|refimpute|all] [reps]

Ours is timed as `python -m pbwt_tpu ...` (interpreter start-up included)
on the host engine.
"""

import os

# host-only workloads: this process and its children stay off any device
os.environ["JAX_PLATFORMS"] = "cpu"
try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
WORKDIR = os.environ.get("PBWT_H2H_DIR", "/tmp/h2h")
REF_SRC = "/root/reference"

HTSLIB_STUB = """
#include "pbwt.h"
const char *pbwtHtslibVersionString(void) { return "stub"; }
PBWT *pbwtReadVcfGT (char *filename) { die("no htslib") ; return 0 ; }
PBWT *pbwtReadVcfPL (char *filename) { die("no htslib") ; return 0 ; }
void pbwtWriteVcf (PBWT *p, char *f, char *r, char *m) { die("no htslib") ; }
"""


def ref_bin() -> str:
    d = os.path.join(WORKDIR, "refbuild")
    out = os.path.join(d, "pbwt_ref")
    if os.path.exists(out):
        return out
    os.makedirs(d, exist_ok=True)
    import glob
    import shutil
    for f in glob.glob(f"{REF_SRC}/*.c") + glob.glob(f"{REF_SRC}/*.h"):
        shutil.copy(f, d)
    with open(os.path.join(d, "version.h"), "w") as fh:
        fh.write('#define PBWT_COMMIT_HASH ""\n')
    with open(os.path.join(d, "pbwtHtslib_stub.c"), "w") as fh:
        fh.write(HTSLIB_STUB)
    srcs = [s for s in os.listdir(d)
            if s.endswith(".c") and s != "pbwtHtslib.c"]
    subprocess.run(["gcc", "-O2", "-w", "-o", out]
                   + [os.path.join(d, s) for s in srcs] + ["-lm", "-lz"],
                   check=True)
    return out


def run_timed(name, cmd, reps, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.setdefault("JAX_PLATFORMS", "cpu")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, cwd=cwd, env=env)
        times.append(time.perf_counter() - t0)
        if r.returncode:
            sys.exit(f"{name}: rc={r.returncode}\n{r.stderr.decode()[-500:]}")
    print(f"  {name:8s} " + " ".join(f"{t:.3f}s" for t in times)
          + f"   (best {min(times):.3f}s)", flush=True)
    return min(times)


def ours_cmd(*args):
    return [sys.executable, "-m", "pbwt_tpu", *args]


def cmp_files(a, b, label):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        same = fa.read() == fb.read()
    print(f"  parity[{label}]: {'OK' if same else 'MISMATCH'}", flush=True)
    if not same:
        sys.exit(1)


def write_panel(path_root, M, N, seed, pos_seed=None, chrom="20"):
    """Deterministic beta-frequency panel written as .pbwt/.sites via our
    writer (format byte-parity with the reference is pinned in-suite).
    ``pos_seed`` fixes the site positions/frequencies independently of the
    haplotype draw so two panels can share their site list (merge)."""
    from pbwt_tpu.core import registry
    from pbwt_tpu.core.pbwt import PBWT, Site
    from pbwt_tpu.io import pbwtfile
    rng_s = np.random.RandomState(seed if pos_seed is None else pos_seed)
    freqs = rng_s.beta(0.2, 0.8, size=N)
    pos = np.sort(rng_s.choice(np.arange(1, max(10_000_000, 2 * N)), N,
                               replace=False))
    als = ["A\tC", "A\tG", "C\tT", "G\tT"]
    rng = np.random.RandomState(seed)
    X = np.empty((M, N), np.uint8)         # blockwise: no (M, N) float64
    B = max(1, (1 << 24) // max(N, 1))
    for r0 in range(0, M, B):
        r1 = min(r0 + B, M)
        X[r0:r1] = rng.random_sample((r1 - r0, N)) < freqs[None, :]
    p = PBWT.from_haplotypes(X)
    p.chrom = chrom
    vd = registry.variation_dict
    p.sites = [Site(x=int(pos[k]), varD=vd.add(als[k % 4]))
               for k in range(N)]
    with open(path_root + ".pbwt", "wb") as f:
        pbwtfile.write_pbwt(p, f)
    with open(path_root + ".sites", "w") as f:
        pbwtfile.write_sites(p, f)
    return X


def write_vcfq(path, X, seed, chrom="7"):
    """vcfq (tab) file for readVcfq-based pipelines (phase fixture)."""
    rng = np.random.RandomState(seed)
    M, N = X.shape
    pos = np.sort(rng.choice(np.arange(10_000, 90_000_000), N,
                             replace=False))
    alleles = "ACGT"
    with open(path, "w") as f:
        for k in range(N):
            r = alleles[rng.randint(4)]
            a = alleles[(alleles.index(r) + 1 + rng.randint(3)) % 4]
            gts = "\t".join(f"{X[2 * i, k]}|{X[2 * i + 1, k]}"
                            for i in range(M // 2))
            f.write(f"{chrom}\t{pos[k]}\t{r}\t{a}\t{gts}\n")


def h2h_merge(reps):
    print("== -merge (5k + 5k haplotypes, 10k sites) ==", flush=True)
    d = os.path.join(WORKDIR, "merge")
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(os.path.join(d, "in1.pbwt")):
        write_panel(os.path.join(d, "in0"), 5000, 10000, 3, pos_seed=3)
        write_panel(os.path.join(d, "in1"), 5000, 10000, 4, pos_seed=3)
    rb = ref_bin()
    run_timed("ref", [rb, "-merge", "in0.pbwt", "in1.pbwt", "-write",
                      "ref.pbwt", "-writeSites", "ref.sites"], reps, d)
    run_timed("ours", ours_cmd("-merge", "in0.pbwt", "in1.pbwt", "-write",
                               "our.pbwt", "-writeSites", "our.sites"),
              reps, d)
    cmp_files(os.path.join(d, "ref.pbwt"), os.path.join(d, "our.pbwt"),
              "pbwt")
    cmp_files(os.path.join(d, "ref.sites"), os.path.join(d, "our.sites"),
              "sites")


def h2h_gtcompare(reps):
    print("== -genotypeCompare (4k x 3k vs corrupted self) ==", flush=True)
    d = os.path.join(WORKDIR, "gtc")
    os.makedirs(d, exist_ok=True)
    rb = ref_bin()
    if not os.path.exists(os.path.join(d, "cor.pbwt")):
        write_panel(os.path.join(d, "pan"), 4000, 3000, 11)
        subprocess.run([rb, "-readAll", "pan", "-corruptSites", "0.99",
                        "0.95", "-writeAll", "cor"], cwd=d, check=True,
                       capture_output=True)
    run_timed("ref", [rb, "-readAll", "cor", "-genotypeCompare", "pan",
                      "-log", "ref.log"], reps, d)
    run_timed("ours", ours_cmd("-readAll", "cor", "-genotypeCompare",
                               "pan", "-log", "our.log"), reps, d)
    r = subprocess.run([rb, "-readAll", "cor", "-genotypeCompare", "pan"],
                       cwd=d, capture_output=True)
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    o = subprocess.run(ours_cmd("-readAll", "cor", "-genotypeCompare",
                                "pan"), cwd=d, capture_output=True, env=env)
    same = r.stdout == o.stdout
    print(f"  parity[stdout]: {'OK' if same else 'MISMATCH'}", flush=True)
    if not same:
        sys.exit(1)


def h2h_imputemissing(reps):
    print("== -imputeMissing (4k x 3k, 10% missing sites) ==", flush=True)
    d = os.path.join(WORKDIR, "imm")
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(os.path.join(d, "pan.pbwt")):
        # panel with a missing sidecar comes from our VCF importer: build
        # a VCF with ./. entries at 10% of sites
        from pbwt_tpu.core.pbwt import PBWT
        rng = np.random.RandomState(21)
        M, N = 4000, 3000
        freqs = rng.beta(0.2, 0.8, size=N)
        X = (rng.random_sample((M, N)) < freqs[None, :]).astype(np.uint8)
        missing_sites = rng.random_sample(N) < 0.1
        pos = np.sort(rng.choice(np.arange(10_000, 90_000_000), N,
                                 replace=False))
        with open(os.path.join(d, "in.vcf"), "w") as f:
            f.write("##fileformat=VCFv4.2\n")
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                    + "\t".join(f"s{i}" for i in range(M // 2)) + "\n")
            for k in range(N):
                gts = []
                for i in range(M // 2):
                    if missing_sites[k] and rng.random_sample() < 0.3:
                        gts.append("./.")
                    else:
                        gts.append(f"{X[2 * i, k]}|{X[2 * i + 1, k]}")
                f.write(f"20\t{pos[k]}\t.\tA\tC\t.\tPASS\t.\tGT\t"
                        + "\t".join(gts) + "\n")
        env = dict(os.environ)
        env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        subprocess.run(ours_cmd("-readVcfGT", "in.vcf", "-writeAll", "pan"),
                       cwd=d, check=True, capture_output=True, env=env)
    rb = ref_bin()
    run_timed("ref", [rb, "-readAll", "pan", "-imputeMissing", "-haps",
                      "ref.haps"], reps, d)
    run_timed("ours", ours_cmd("-readAll", "pan", "-imputeMissing",
                               "-haps", "our.haps"), reps, d)
    cmp_files(os.path.join(d, "ref.haps"), os.path.join(d, "our.haps"),
              "haps")


def h2h_phase(reps):
    print("== -phase 4 (4k x 3k vcfq) ==", flush=True)
    d = os.path.join(WORKDIR, "phase")
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(os.path.join(d, "in.tab")):
        rng = np.random.RandomState(31)
        M, N = 4000, 3000
        F = (rng.random_sample((40, N)) < 0.35).astype(np.uint8)
        X = F[rng.randint(40, size=M)] ^ (
            rng.random_sample((M, N)) < 0.01).astype(np.uint8)
        write_vcfq(os.path.join(d, "in.tab"), X, 32)
    rb = ref_bin()
    run_timed("ref", [rb, "-readVcfq", "in.tab", "-phase", "4", "-haps",
                      "ref.haps"], reps, d)
    run_timed("ours", ours_cmd("-readVcfq", "in.tab", "-phase", "4",
                               "-haps", "our.haps"), reps, d)
    cmp_files(os.path.join(d, "ref.haps"), os.path.join(d, "our.haps"),
              "haps")


def h2h_paint(reps):
    print("== -paint (2k x 3k) ==", flush=True)
    d = os.path.join(WORKDIR, "paint")
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(os.path.join(d, "pan.pbwt")):
        rng = np.random.RandomState(41)
        M, N = 2000, 3000
        F = (rng.random_sample((30, N)) < 0.35).astype(np.uint8)
        X = F[rng.randint(30, size=M)] ^ (
            rng.random_sample((M, N)) < 0.005).astype(np.uint8)
        from pbwt_tpu.core import registry
        from pbwt_tpu.core.pbwt import PBWT, Site
        from pbwt_tpu.io import pbwtfile
        p = PBWT.from_haplotypes(X)
        p.chrom = "20"
        vd = registry.variation_dict
        pos = np.sort(rng.choice(np.arange(1, 10_000_000), N,
                                 replace=False))
        p.sites = [Site(x=int(pos[k]), varD=vd.add("A\tC"))
                   for k in range(N)]
        with open(os.path.join(d, "pan.pbwt"), "wb") as f:
            pbwtfile.write_pbwt(p, f)
        with open(os.path.join(d, "pan.sites"), "w") as f:
            pbwtfile.write_sites(p, f)
    rb = ref_bin()
    run_timed("ref", [rb, "-readAll", "pan", "-paint", "ref"], reps, d)
    run_timed("ours", ours_cmd("-readAll", "pan", "-paint", "our"),
              reps, d)
    for sfx in ("chunkcounts", "chunklengths", "regionsquaredchunkcounts",
                "regionchunkcounts"):
        cmp_files(os.path.join(d, f"ref.{sfx}.out"),
                  os.path.join(d, f"our.{sfx}.out"), sfx)


def h2h_refimpute(reps):
    print("== -referenceImpute (panel 10k x 10k -> 1k targets, 2.5k-site "
          "frame) ==", flush=True)
    d = os.path.join(WORKDIR, "rimp")
    os.makedirs(d, exist_ok=True)
    rb = ref_bin()
    if not os.path.exists(os.path.join(d, "tgt.pbwt")):
        write_panel(os.path.join(d, "all"), 11000, 10000, 51)
        subprocess.run([rb, "-readAll", "all", "-subsample", "0", "10000",
                        "-writeAll", "refpan"], cwd=d, check=True,
                       capture_output=True)
        # target: the other 1000 haps on a 1-in-4 subset of sites
        subprocess.run([rb, "-readAll", "all", "-subsample", "10000",
                        "1000", "-writeAll", "tgt_full"], cwd=d,
                       check=True, capture_output=True)
        rng = np.random.RandomState(52)
        keep = np.sort(rng.choice(10000, 2500, replace=False))
        with open(os.path.join(d, "tgt_full.sites")) as f:
            lines = f.readlines()
        with open(os.path.join(d, "frame.sites"), "w") as f:
            f.writelines([lines[i] for i in keep])
        subprocess.run([rb, "-readAll", "tgt_full", "-selectSites",
                        "frame.sites", "-writeAll", "tgt"], cwd=d,
                       check=True, capture_output=True)
    run_timed("ref", [rb, "-readAll", "tgt", "-referenceImpute", "refpan",
                      "-haps", "ref.haps"], reps, d)
    run_timed("ours", ours_cmd("-readAll", "tgt", "-referenceImpute",
                               "refpan", "-haps", "our.haps"), reps, d)
    cmp_files(os.path.join(d, "ref.haps"), os.path.join(d, "our.haps"),
              "haps")


def h2h_merge_xl(reps):
    print("== -merge XL (20k + 20k haplotypes, 20k sites) ==", flush=True)
    d = os.path.join(WORKDIR, "merge_xl")
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(os.path.join(d, "in1.pbwt")):
        write_panel(os.path.join(d, "in0"), 20000, 20000, 61, pos_seed=60)
        write_panel(os.path.join(d, "in1"), 20000, 20000, 62, pos_seed=60)
    rb = ref_bin()
    run_timed("ref", [rb, "-merge", "in0.pbwt", "in1.pbwt", "-write",
                      "ref.pbwt", "-writeSites", "ref.sites"], reps, d)
    run_timed("ours", ours_cmd("-merge", "in0.pbwt", "in1.pbwt", "-write",
                               "our.pbwt", "-writeSites", "our.sites"),
              reps, d)
    cmp_files(os.path.join(d, "ref.pbwt"), os.path.join(d, "our.pbwt"),
              "pbwt")


def h2h_gtcompare_xl(reps):
    print("== -genotypeCompare XL (16k x 16k) ==", flush=True)
    d = os.path.join(WORKDIR, "gtc_xl")
    os.makedirs(d, exist_ok=True)
    rb = ref_bin()
    if not os.path.exists(os.path.join(d, "cor.pbwt")):
        write_panel(os.path.join(d, "pan"), 16000, 16000, 71)
        subprocess.run([rb, "-readAll", "pan", "-corruptSites", "0.99",
                        "0.95", "-writeAll", "cor"], cwd=d, check=True,
                       capture_output=True)
    run_timed("ref", [rb, "-readAll", "cor", "-genotypeCompare", "pan",
                      "-log", "ref.log"], reps, d)
    run_timed("ours", ours_cmd("-readAll", "cor", "-genotypeCompare",
                               "pan", "-log", "our.log"), reps, d)
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([rb, "-readAll", "cor", "-genotypeCompare", "pan"],
                       cwd=d, capture_output=True)
    o = subprocess.run(ours_cmd("-readAll", "cor", "-genotypeCompare",
                                "pan"), cwd=d, capture_output=True, env=env)
    same = r.stdout == o.stdout
    print(f"  parity[stdout]: {'OK' if same else 'MISMATCH'}", flush=True)
    if not same:
        sys.exit(1)


def h2h_imputemissing_xl(reps):
    print("== -imputeMissing XL (12k x 8k, 10% missing sites) ==",
          flush=True)
    d = os.path.join(WORKDIR, "imm_xl")
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(os.path.join(d, "pan.pbwt")):
        # synthesise the root directly (a 12k-sample VCF text would be
        # ~1 GB): panel + pack3 missing sidecar via our own writer
        from pbwt_tpu.core import registry
        from pbwt_tpu.core.pbwt import PBWT, Site
        from pbwt_tpu.core import pack3 as p3
        from pbwt_tpu.io import pbwtfile
        rng = np.random.RandomState(81)
        M, N = 12000, 8000
        freqs = rng.beta(0.2, 0.8, size=N)
        X = np.empty((M, N), np.uint8)
        B = max(1, (1 << 24) // N)
        for r0 in range(0, M, B):
            r1 = min(r0 + B, M)
            X[r0:r1] = rng.random_sample((r1 - r0, N)) < freqs[None, :]
        missing_sites = np.nonzero(rng.random_sample(N) < 0.1)[0]
        zmiss = bytearray(b"\x00")           # offset-0 marker byte
        moff = np.zeros(N, np.int64)
        for k in missing_sites:
            mrow = (rng.random_sample(M) < 0.3).astype(np.uint8)
            X[:, k] *= 1 - mrow              # missing -> 0, like the ref
            moff[k] = len(zmiss)             # byte offset (0 = none)
            zmiss.extend(p3.pack3(mrow))
        p = PBWT.from_haplotypes(X)
        p.chrom = "20"
        vd = registry.variation_dict
        pos = np.sort(rng.choice(np.arange(1, 90_000_000), N,
                                 replace=False))
        p.sites = [Site(x=int(pos[k]), varD=vd.add("A\tC"))
                   for k in range(N)]
        p.zMissing = bytes(zmiss)
        p.missingOffset = moff
        pbwtfile.write_all(p, os.path.join(d, "pan"))
    rb = ref_bin()
    run_timed("ref", [rb, "-readAll", "pan", "-imputeMissing", "-haps",
                      "ref.haps"], reps, d)
    run_timed("ours", ours_cmd("-readAll", "pan", "-imputeMissing",
                               "-haps", "our.haps"), reps, d)
    cmp_files(os.path.join(d, "ref.haps"), os.path.join(d, "our.haps"),
              "haps")


def h2h_paint_xl(reps):
    print("== -paint XL (6k x 6k) ==", flush=True)
    d = os.path.join(WORKDIR, "paint_xl")
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(os.path.join(d, "pan.pbwt")):
        rng = np.random.RandomState(91)
        M, N = 6000, 6000
        F = (rng.random_sample((40, N)) < 0.35).astype(np.uint8)
        X = F[rng.randint(40, size=M)] ^ (
            rng.random_sample((M, N)) < 0.005).astype(np.uint8)
        from pbwt_tpu.core import registry
        from pbwt_tpu.core.pbwt import PBWT, Site
        from pbwt_tpu.io import pbwtfile
        p = PBWT.from_haplotypes(X)
        p.chrom = "20"
        vd = registry.variation_dict
        pos = np.sort(rng.choice(np.arange(1, 60_000_000), N,
                                 replace=False))
        p.sites = [Site(x=int(pos[k]), varD=vd.add("A\tC"))
                   for k in range(N)]
        with open(os.path.join(d, "pan.pbwt"), "wb") as f:
            pbwtfile.write_pbwt(p, f)
        with open(os.path.join(d, "pan.sites"), "w") as f:
            pbwtfile.write_sites(p, f)
    rb = ref_bin()
    run_timed("ref", [rb, "-readAll", "pan", "-paint", "ref"], reps, d)
    run_timed("ours", ours_cmd("-readAll", "pan", "-paint", "our"),
              reps, d)
    for sfx in ("chunkcounts", "chunklengths"):
        cmp_files(os.path.join(d, f"ref.{sfx}.out"),
                  os.path.join(d, f"our.{sfx}.out"), sfx)


def h2h_phase_xl(reps):
    print("== -phase XL (8k x 6k vcfq) ==", flush=True)
    d = os.path.join(WORKDIR, "phase_xl")
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(os.path.join(d, "in.tab")):
        rng = np.random.RandomState(101)
        M, N = 8000, 6000
        F = (rng.random_sample((60, N)) < 0.35).astype(np.uint8)
        X = F[rng.randint(60, size=M)] ^ (
            rng.random_sample((M, N)) < 0.01).astype(np.uint8)
        write_vcfq(os.path.join(d, "in.tab"), X, 102)
    rb = ref_bin()
    run_timed("ref", [rb, "-readVcfq", "in.tab", "-phase", "4", "-haps",
                      "ref.haps"], reps, d)
    run_timed("ours", ours_cmd("-readVcfq", "in.tab", "-phase", "4",
                               "-haps", "our.haps"), reps, d)
    cmp_files(os.path.join(d, "ref.haps"), os.path.join(d, "our.haps"),
              "haps")


def h2h_refimpute_xl(reps):
    print("== -referenceImpute XL (panel 20k x 16k -> 2k targets, "
          "4k-site frame) ==", flush=True)
    d = os.path.join(WORKDIR, "rimp_xl")
    os.makedirs(d, exist_ok=True)
    rb = ref_bin()
    if not os.path.exists(os.path.join(d, "tgt.pbwt")):
        write_panel(os.path.join(d, "all"), 22000, 16000, 111)
        subprocess.run([rb, "-readAll", "all", "-subsample", "0", "20000",
                        "-writeAll", "refpan"], cwd=d, check=True,
                       capture_output=True)
        subprocess.run([rb, "-readAll", "all", "-subsample", "20000",
                        "2000", "-writeAll", "tgt_full"], cwd=d,
                       check=True, capture_output=True)
        rng = np.random.RandomState(112)
        keep = np.sort(rng.choice(16000, 4000, replace=False))
        with open(os.path.join(d, "tgt_full.sites")) as f:
            lines = f.readlines()
        with open(os.path.join(d, "frame.sites"), "w") as f:
            f.writelines([lines[i] for i in keep])
        subprocess.run([rb, "-readAll", "tgt_full", "-selectSites",
                        "frame.sites", "-writeAll", "tgt"], cwd=d,
                       check=True, capture_output=True)
    run_timed("ref", [rb, "-readAll", "tgt", "-referenceImpute", "refpan",
                      "-haps", "ref.haps"], reps, d)
    run_timed("ours", ours_cmd("-readAll", "tgt", "-referenceImpute",
                               "refpan", "-haps", "our.haps"), reps, d)
    cmp_files(os.path.join(d, "ref.haps"), os.path.join(d, "our.haps"),
              "haps")


ALL = {"merge": h2h_merge, "gtcompare": h2h_gtcompare,
       "imputemissing": h2h_imputemissing, "phase": h2h_phase,
       "paint": h2h_paint, "refimpute": h2h_refimpute,
       "merge-xl": h2h_merge_xl, "gtcompare-xl": h2h_gtcompare_xl,
       "imputemissing-xl": h2h_imputemissing_xl,
       "paint-xl": h2h_paint_xl, "phase-xl": h2h_phase_xl,
       "refimpute-xl": h2h_refimpute_xl}


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    os.makedirs(WORKDIR, exist_ok=True)
    for name, fn in ALL.items():
        if which in (name, "all"):
            fn(reps)


if __name__ == "__main__":
    main()
