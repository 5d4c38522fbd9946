"""Cross-validation against the actual reference binary.

Builds richarddurbin/pbwt from the read-only reference checkout (with an
htslib stub, so VCF commands are excluded - those are covered by the golden
suite) and byte-compares our CLI's output on synthetic MaCS/vcfq data.

Known reference defects we do NOT reproduce (validated manually):
  - pbwt4hapsStats overruns its fixed-size Hap4Stats arrays for M > 80
    (pbwtGeneticMap.c:108-112 lastPat[20] indexed by haplotype), printing
    uninitialised garbage; we implement the intended semantics.
  - referencePhase/selectSites segfault on MaCS imports (NULL variation
    names); we print "(null)" like the reference's own writeSites printf.
  - readHapLegend consumes two legend lines per hap line (getVariation eats
    the newline, then the skip loop eats the next line), garbling its own
    writeImputeRef output; we pair line i of the legend with hap line i.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SRC = "/root/reference"

HTSLIB_STUB = """
#include "utils.h"
#include "pbwt.h"
const char *pbwtHtslibVersionString(void) { return "stub"; }
PBWT *pbwtReadVcfGT (char *filename) { die("no htslib") ; return 0 ; }
PBWT *pbwtReadVcfPL (char *filename) { die("no htslib") ; return 0 ; }
void pbwtWriteVcf (PBWT *p, char *f, char *r, char *m) { die("no htslib") ; }
"""


@pytest.fixture(scope="module")
def ref_bin(tmp_path_factory):
    if not os.path.isdir(REF_SRC):
        pytest.skip("reference sources not available")
    d = tmp_path_factory.mktemp("refbuild")
    import glob
    import shutil
    for f in glob.glob(f"{REF_SRC}/*.c") + glob.glob(f"{REF_SRC}/*.h"):
        shutil.copy(f, d)
    (d / "version.h").write_text('#define PBWT_COMMIT_HASH ""\n')
    (d / "pbwtHtslib_stub.c").write_text(HTSLIB_STUB)
    srcs = [s for s in os.listdir(d)
            if s.endswith(".c") and s != "pbwtHtslib.c"]
    res = subprocess.run(["gcc", "-O2", "-w", "-o", str(d / "pbwt_ref")]
                         + [str(d / s) for s in srcs] + ["-lm", "-lz"],
                         capture_output=True)
    if res.returncode != 0:
        pytest.skip(f"reference build failed: {res.stderr[:200]}")
    return str(d / "pbwt_ref")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("xdata")
    rng = np.random.RandomState(1)
    M, N, L = 300, 200, 1e6
    F = (rng.random_sample((20, N)) < 0.35).astype(np.uint8)
    X = F[rng.randint(20, size=M)] ^ (rng.random_sample((M, N)) < 0.01).astype(np.uint8)
    pos = np.sort(rng.random_sample(N))
    with open(d / "sim.macs", "w") as f:
        f.write(f"COMMAND:\tmacs {M} {L:.0f}\nSEED:\t12345\n")
        for k in range(N):
            hap = "".join("01"[v] for v in X[:, k])
            f.write(f"SITE:\t{k}\t{pos[k]:.8f}\t0.5\t{hap}\n")
    rng = np.random.RandomState(5)
    M2, N2 = 120, 150
    F = (rng.random_sample((10, N2)) < 0.35).astype(np.uint8)
    X2 = F[rng.randint(10, size=M2)] ^ (rng.random_sample((M2, N2)) < 0.01).astype(np.uint8)
    pos2 = np.sort(rng.choice(np.arange(10000, 900000), N2, replace=False))
    alleles = "ACGT"
    with open(d / "big.tab", "w") as f:
        for k in range(N2):
            r = alleles[rng.randint(4)]
            a = alleles[(alleles.index(r) + 1 + rng.randint(3)) % 4]
            gts = "\t".join(f"{X2[2 * i, k]}|{X2[2 * i + 1, k]}"
                            for i in range(M2 // 2))
            f.write(f"7\t{pos2[k]}\t{r}\t{a}\t{gts}\n")
    return str(d)


def run_ref(ref_bin, args, cwd, with_err=False):
    res = subprocess.run([ref_bin] + args, capture_output=True, cwd=cwd)
    assert res.returncode == 0, res.stderr[-300:]
    return (res.stdout, res.stderr) if with_err else res.stdout


def run_ours(args, cwd, with_err=False):
    # pin the host engine: the crosschecks assert byte-parity of the host/C
    # paths
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.setdefault("PBWT_TPU_DEVICE", "0")
    res = subprocess.run([sys.executable, "-m", "pbwt_tpu"] + args,
                         capture_output=True, cwd=cwd, env=env)
    assert res.returncode == 0, res.stderr[-300:]
    return (res.stdout, res.stderr) if with_err else res.stdout


# timeUpdate resource lines (utils.c:173-198): shape must match, numbers are
# machine noise
_TIMING = __import__("re").compile(
    rb"^user\t\S+\tsystem\t\S+\tmax_RSS\t\S+\tMemory\t\S+$", 8)  # re.M


def norm_stderr(err: bytes) -> bytes:
    return _TIMING.sub(b"user\t#\tsystem\t#\tmax_RSS\t#\tMemory\t#", err)


CASES = [
    ("macs-haps", ["-readMacs", "sim.macs", "-haps", "-"]),
    ("macs-maxwithin", ["-readMacs", "sim.macs", "-maxWithin"]),
    ("macs-longwithin", ["-readMacs", "sim.macs", "-longWithin", "50"]),
    ("macs-stats-hist", ["-readMacs", "sim.macs", "-stats", "-maxWithin"]),
    ("macs-sfs", ["-readMacs", "sim.macs", "-sfs"]),
    ("macs-subsites", ["-readMacs", "sim.macs", "-subsites", "0.1", "0.5",
                       "-haps", "-"]),
    ("macs-subrange", ["-readMacs", "sim.macs", "-subrange", "20", "100",
                       "-haps", "-"]),
    ("macs-subsample", ["-readMacs", "sim.macs", "-subsample", "7", "90",
                        "-haps", "-"]),
    ("macs-phase", ["-readMacs", "sim.macs", "-subsample", "0", "40",
                    "-phase", "4", "-haps", "-"]),
    ("vcfq-fit1", ["-readVcfq", "big.tab", "-fitAlphaBeta", "1"]),
    ("vcfq-llcopy", ["-readVcfq", "big.tab", "-subsample", "0", "12",
                     "-llCopyModel", "0.1", "0.05"]),
    ("vcfq-ie1", ["-readVcfq", "big.tab", "-imputeExplore", "1"]),
    ("vcfq-ie2", ["-readVcfq", "big.tab", "-imputeExplore", "2"]),
    ("vcfq-ie3", ["-readVcfq", "big.tab", "-imputeExplore", "3"]),
    ("vcfq-ie4", ["-readVcfq", "big.tab", "-imputeExplore", "4"]),
    ("vcfq-check-max", ["-readVcfq", "big.tab", "-check", "-maxWithin"]),
    # corruption/simulation: bit-reproducible via the glibc rand() stream
    ("macs-corrupt-sites", ["-readMacs", "sim.macs", "-corruptSites",
                            "0.3", "0.2", "-haps", "-"]),
    ("macs-corrupt-samples", ["-readMacs", "sim.macs", "-corruptSamples",
                              "0.25", "0.1", "-haps", "-"]),
    ("macs-copy-samples", ["-readMacs", "sim.macs", "-copySamples",
                           "50", "20", "-haps", "-"]),
    ("macs-corrupt-chain", ["-readMacs", "sim.macs", "-corruptSites",
                            "0.5", "0.1", "-corruptSamples", "0.2", "0.3",
                            "-haps", "-"]),
]


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_stdout_identical(ref_bin, data_dir, name, args):
    """stdout byte-identical; stderr (logFile) identical after normalizing
    the numeric fields of timeUpdate lines."""
    r_out, r_err = run_ref(ref_bin, args, data_dir, with_err=True)
    o_out, o_err = run_ours(args, data_dir, with_err=True)
    assert r_out == o_out
    assert norm_stderr(r_err) == norm_stderr(o_err)


def test_match_and_impute_pipeline(ref_bin, data_dir):
    """matchDynamic/Indexed/Naive + the full referenceImpute path, both
    implementations fed identical .pbwt inputs."""
    d = data_dir
    run_ref(ref_bin, ["-readVcfq", "big.tab", "-subsample", "0", "100",
                      "-writeAll", "panel"], d)
    run_ref(ref_bin, ["-readVcfq", "big.tab", "-subsample", "100", "20",
                      "-write", "query.pbwt"], d)
    for cmd in ("-matchDynamic", "-matchIndexed", "-matchNaive"):
        a = ["-read", "panel.pbwt", cmd, "query.pbwt"]
        assert run_ref(ref_bin, a, d) == run_ours(a, d), cmd
    # referencePhase
    a = ["-readVcfq", "big.tab", "-subsample", "100", "10",
         "-referencePhase", "panel", "-haps", "-"]
    assert run_ref(ref_bin, a, d) == run_ours(a, d)
    # referenceImpute (target on a site subset) + dosage bytes
    run_ref(ref_bin, ["-readVcfq", "big.tab", "-subsample", "100", "10",
                      "-subsites", "0.0", "0.5", "-writeAll", "target"], d)
    a = ["-read", "target.pbwt", "-readSites", "target.sites",
         "-referenceImpute", "panel", "-haps", "-"]
    assert run_ref(ref_bin, a, d) == run_ours(a, d)
    # nSparse > 1 variant (logs the "(nSparse = ...)" prefix, pbwtImpute.c:1136)
    a = ["-read", "target.pbwt", "-readSites", "target.sites",
         "-referenceImpute", "panel", "4", "0.5", "-haps", "-"]
    assert run_ref(ref_bin, a, d) == run_ours(a, d)
    run_ref(ref_bin, a[:-2] + ["-writeDosage", "rd.bin"], d)
    run_ours(a[:-2] + ["-writeDosage", "od.bin"], d)
    assert open(f"{d}/rd.bin", "rb").read() == open(f"{d}/od.bin", "rb").read()


def test_text_format_roundtrips_identical(ref_bin, data_dir):
    """gen/hap/impute2/PHASE exporters and re-importers vs the reference
    binary (writers produce identical bytes; readers rebuild identical
    haplotype matrices)."""
    d = data_dir
    base = ["-readVcfq", "big.tab"]
    # exporters: byte-identical output files
    for args, outs in [
        (base + ["-writeGen", "rg.gen"], ["rg.gen"]),
        (base + ["-haps", "rh.hap"], ["rh.hap"]),
        (base + ["-writeImputeRef", "rimp"],
         ["rimp.imputeHaps", "rimp.imputeLegend"]),
        (base + ["-writeImputeHapsG", "rg2.hapsg"], ["rg2.hapsg"]),
        (base + ["-writePhase", "rp.phase"], ["rp.phase"]),
    ]:
        run_ref(ref_bin, args, d)
        ref_outs = {o: open(f"{d}/{o}", "rb").read() for o in outs}
        run_ours(args, d)
        for o in outs:
            assert open(f"{d}/{o}", "rb").read() == ref_outs[o], o
    # importers: identical -haps output when re-reading what we wrote
    for args in [
        ["-readGen", "rg.gen", "7", "-haps", "-"],
        ["-readPhase", "rp.phase", "-haps", "-"],
    ]:
        assert run_ref(ref_bin, args, d) == run_ours(args, d), args[0]


def test_genotype_compare_identical(ref_bin, data_dir):
    d = data_dir
    run_ref(ref_bin, ["-readVcfq", "big.tab", "-writeAll", "gcbase"], d)
    # compare a corrupted copy against the original: corruption must be
    # deterministic and shared, so corrupt by site subsetting instead
    a = ["-readAll", "gcbase", "-selectSites", "gcbase.sites",
         "-genotypeCompare", "gcbase"]
    assert run_ref(ref_bin, a, d) == run_ours(a, d)


def test_paint_outputs_identical(ref_bin, data_dir):
    d = data_dir
    run_ref(ref_bin, ["-readMacs", "sim.macs", "-subsample", "0", "30",
                      "-paint", "refp"], d)
    run_ours(["-readMacs", "sim.macs", "-subsample", "0", "30",
              "-paint", "ourp"], d)
    for t in ("chunkcounts.out", "chunklengths.out",
              "regionsquaredchunkcounts.out", "regionchunkcounts.out"):
        assert (open(f"{d}/refp.{t}").read() == open(f"{d}/ourp.{t}").read()), t


def test_checkpoint_files_identical(ref_bin, data_dir, tmp_path):
    """-checkpoint n during a text import: alternating check_A/check_B roots
    (pbwtCheckPoint, pbwtIO.c:158-168) must match the reference's bytes."""
    rd = tmp_path / "ref"
    od = tmp_path / "ours"
    rd.mkdir()
    od.mkdir()
    args = ["-checkpoint", "60", "-readMacs", f"{data_dir}/sim.macs",
            "-write", "final.pbwt"]
    run_ref(ref_bin, args, str(rd))
    run_ours(args, str(od))
    ref_files = sorted(f for f in os.listdir(rd) if f.startswith("check_"))
    our_files = sorted(f for f in os.listdir(od) if f.startswith("check_"))
    assert ref_files == our_files and ref_files
    for f in ref_files:
        assert (rd / f).read_bytes() == (od / f).read_bytes(), f
    assert (rd / "final.pbwt").read_bytes() == (od / "final.pbwt").read_bytes()


def test_checkpoint_missing_offsets(tmp_path):
    """A checkpoint taken after the first missing genotype must write a
    .missing sidecar whose offsets are front-padded exactly like the final
    write (reference Array zero-fills leading sites, pbwtHtslib.c:144).
    htslib-stubbed reference can't run VCF commands, so this is a
    self-consistency check: checkpoint sidecars == prefix of the full import."""
    d = tmp_path
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\tS1\tS2"]
    rng = np.random.RandomState(3)
    for k in range(20):
        gts = []
        for s in range(3):
            # missing genotypes only from site 5 onwards
            if k >= 5 and rng.random_sample() < 0.3:
                gts.append(".|.")
            else:
                gts.append(f"{rng.randint(2)}|{rng.randint(2)}")
        lines.append(f"1\t{1000 + 10 * k}\t.\tA\tC\t.\tPASS\t.\tGT\t"
                     + "\t".join(gts))
    (d / "m.vcf").write_text("\n".join(lines) + "\n")
    run_ours(["-checkpoint", "8", "-readVcfGT", "m.vcf",
              "-writeAll", "full"], str(d))
    import sys
    sys.path.insert(0, REPO)
    from pbwt_tpu.io import pbwtfile
    full = pbwtfile.read_all(str(d / "full"))
    assert full.missingOffset is not None
    for root, nc in (("check_A", 8), ("check_B", 16)):
        chk = pbwtfile.read_all(str(d / root))
        assert chk.N == nc
        np.testing.assert_array_equal(chk.missingOffset,
                                      full.missingOffset[:nc])
        assert full.zMissing.startswith(chk.zMissing)
        np.testing.assert_array_equal(chk.haplotypes(),
                                      full.haplotypes()[:, :nc])


def test_paint_sparse_contents_identical(ref_bin, data_dir):
    """-paintSparse: decompressed contents of all five .s.out.gz streams
    (pbwtPaint.c:211-328).  gzip framing may differ, so compare gunzipped
    payloads."""
    import gzip
    d = data_dir
    base = ["-readMacs", "sim.macs", "-subsample", "0", "30"]
    run_ref(ref_bin, base + ["-paintSparse", "refs", "10", "2", "0"], d)
    run_ours(base + ["-paintSparse", "ours", "10", "2", "0"], d)
    for t in ("nregions.s.out.gz", "chunkcounts.s.out.gz",
              "chunklengths.s.out.gz", "regionsquaredchunkcounts.s.out.gz",
              "regionchunkcounts.s.out.gz"):
        ref = gzip.open(f"{d}/refs.{t}").read()
        ours = gzip.open(f"{d}/ours.{t}").read()
        assert ref == ours, t


def test_binary_roundtrip_identical(ref_bin, data_dir):
    d = data_dir
    run_ref(ref_bin, ["-readMacs", "sim.macs", "-buildReverse",
                      "-writeAll", "refall"], d)
    run_ours(["-readMacs", "sim.macs", "-buildReverse",
              "-writeAll", "ourall"], d)
    for t in ("pbwt", "sites", "reverse"):
        assert (open(f"{d}/refall.{t}", "rb").read()
                == open(f"{d}/ourall.{t}", "rb").read()), t


def test_pretty_siteinfo_identical(ref_bin, data_dir):
    """prettyPlot / exportSiteInfo file outputs (pbwtMain.c:60-100); ours
    streams the pack3 cursor instead of materialising the matrix."""
    d = data_dir
    run_ref(ref_bin, ["-readMacs", "sim.macs", "-pretty", "rp.txt", "150"], d)
    run_ours(["-readMacs", "sim.macs", "-pretty", "op.txt", "150"], d)
    assert open(f"{d}/rp.txt").read() == open(f"{d}/op.txt").read()
    run_ref(ref_bin, ["-readMacs", "sim.macs", "-siteInfo", "rs.txt",
                      "5", "40"], d)
    run_ours(["-readMacs", "sim.macs", "-siteInfo", "os.txt", "5", "40"], d)
    assert open(f"{d}/rs.txt").read() == open(f"{d}/os.txt").read()


def test_impute_missing_crosscheck(ref_bin, data_dir, tmp_path):
    """imputeMissing end-to-end vs the reference binary: the missing
    sidecar is produced by our VCF importer (the reference build here has
    no htslib), both then read the same root.  Covers a real frame
    (missing confined to a site subset) and the every-site-missing
    degenerate (empty frame)."""
    rng = np.random.RandomState(17)
    ns, N = 60, 120
    M = 2 * ns
    F = (rng.random_sample((8, N)) < 0.4).astype(np.uint8)
    X = F[rng.randint(8, size=M)] ^ (rng.random_sample((M, N)) < 0.01)
    pos = np.sort(rng.choice(np.arange(1000, 10**6), N, replace=False))
    for tag, site_rate, gt_rate in (("part", 0.15, 0.1), ("all", 1.0, 0.02)):
        miss_site = rng.random_sample(N) < site_rate
        with open(tmp_path / f"m_{tag}.vcf", "w") as f:
            f.write("##fileformat=VCFv4.2\n##contig=<ID=7>\n")
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                    + "\t".join(f"S{i}" for i in range(ns)) + "\n")
            for k in range(N):
                miss = (rng.random_sample(M) < gt_rate) if miss_site[k] \
                    else np.zeros(M, bool)
                if tag == "all":
                    miss[k % M] = True        # every site incomplete
                gts = "\t".join(
                    ("." if miss[2*i] else str(X[2*i, k])) + "|"
                    + ("." if miss[2*i+1] else str(X[2*i+1, k]))
                    for i in range(ns))
                f.write(f"7\t{pos[k]}\t.\tA\tC\t.\tPASS\t.\tGT\t{gts}\n")
        run_ours(["-readVcfGT", f"m_{tag}.vcf", "-writeAll", f"root_{tag}"],
                 str(tmp_path))
        args = ["-readAll", f"root_{tag}", "-imputeMissing", "-haps", "-"]
        assert run_ref(ref_bin, args, str(tmp_path)) \
            == run_ours(args, str(tmp_path)), tag


def test_merge_duplicate_positions_crosscheck(ref_bin, data_dir, tmp_path):
    """Merge semantics with duplicate (pos, allele) keys: the reference's
    reader advance collapses duplicates and consumes one column per KEY
    (pbwtMerge.c:78-127) — byte-compare .pbwt and .sites.  Also pins the
    readMatchChrom EOF artefact: a '.'-chromosome sites file round-trips
    to an EMPTY chrom column, not '.'."""
    rng = np.random.RandomState(23)
    M, N = 40, 60
    X = (rng.random_sample((M, N)) < 0.4).astype(np.uint8)
    pos = np.sort(rng.randint(1, 30, size=N))          # many duplicates
    with open(tmp_path / "dup.macs", "w") as f:
        f.write(f"COMMAND:\tmacs {M} 100\nSEED:\t1\n")
        for k in range(N):
            f.write(f"SITE:\t{k}\t{pos[k] / 100:.6f}\t0.5\t"
                    + "".join("01"[v] for v in X[:, k]) + "\n")
    for tool, tag in ((lambda a: run_ref(ref_bin, a, str(tmp_path)), "r"),
                      (lambda a: run_ours(a, str(tmp_path)), "o")):
        tool(["-readMacs", "dup.macs", "-subsample", "0", "20",
              "-writeAll", f"{tag}_a"])
        tool(["-readMacs", "dup.macs", "-subsample", "20", "20",
              "-writeAll", f"{tag}_b"])
        tool(["-merge", f"{tag}_a.pbwt", f"{tag}_b.pbwt",
              "-writeAll", f"{tag}_m"])
    for sfx in ("pbwt", "sites"):
        assert ((tmp_path / f"r_m.{sfx}").read_bytes()
                == (tmp_path / f"o_m.{sfx}").read_bytes()), sfx
    # chrom EOF artefact through a readAll round trip
    a = ["-readAll", "r_a", "-writeSites", "-"]
    assert run_ref(ref_bin, a, str(tmp_path)) == run_ours(a, str(tmp_path))
