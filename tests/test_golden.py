"""Golden-file integration tests: the port of the reference test/test.pl
harness (byte-compares our CLI output against the reference's checked-in
expected files on the same fixtures)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pbwt(args, cwd):
    """Run our CLI in a subprocess; returns (stdout_bytes, stderr_bytes)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.setdefault("JAX_PLATFORMS", "cpu")
    # pin the host engine (byte-parity contract)
    env.setdefault("PBWT_TPU_DEVICE", "0")
    res = subprocess.run([sys.executable, "-m", "pbwt_tpu"] + args,
                         cwd=cwd, capture_output=True, env=env)
    assert res.returncode == 0, res.stderr.decode()
    return res.stdout, res.stderr


def read(path, mode="rb"):
    with open(path, mode) as fp:
        return fp.read()


@pytest.fixture
def tmp(tmp_path):
    return str(tmp_path)


def _strip_pbwt_headers(vcf_bytes: bytes) -> bytes:
    return b"\n".join(l for l in vcf_bytes.split(b"\n")
                      if not l.startswith(b"##pbwt"))


def test_pbwt_roundtrip(ref_test_dir, tmp):
    """test_pbwt (test.pl:179-184): vcfq import -> .pbwt -> -haps parity."""
    for name in ("merge.1", "merge.2"):
        pbwt(["-readVcfq", f"{ref_test_dir}/{name}.tab",
              "-write", f"{tmp}/{name}.pbwt",
              "-writeSites", f"{tmp}/{name}.sites"], tmp)
        pbwt(["-read", f"{tmp}/{name}.pbwt", "-haps", f"{tmp}/{name}.out"], tmp)
        assert read(f"{tmp}/{name}.out") == read(f"{ref_test_dir}/{name}.out")


def test_write_vcf(ref_test_dir, tmp):
    """test_write_vcf (test.pl:186-193): 4 write modes round-tripped."""
    pbwt(["-readVcfq", f"{ref_test_dir}/merge.1.tab",
          "-write", f"{tmp}/merge.1.pbwt",
          "-writeSites", f"{tmp}/merge.1.sites"], tmp)
    expected = read(f"{ref_test_dir}/merge.1.vcf")

    out, _ = pbwt(["-read", f"{tmp}/merge.1.pbwt", "-readSites",
                   f"{tmp}/merge.1.sites", "-writeVcf", "-"], tmp)
    assert _strip_pbwt_headers(out) == expected

    for mode in ("-writeVcfGz", "-writeBcf", "-writeBcfGz"):
        pbwt(["-read", f"{tmp}/merge.1.pbwt", "-readSites",
              f"{tmp}/merge.1.sites", mode, f"{tmp}/tmp.x"], tmp)
        out, _ = pbwt(["-readVcfGT", f"{tmp}/tmp.x", "-writeVcf", "-"], tmp)
        assert _strip_pbwt_headers(out) == expected, mode


def test_read_vcf_gt(ref_test_dir, tmp):
    """test_read_vcf_gt (test.pl:195-199)."""
    out, _ = pbwt(["-readVcfGT", f"{ref_test_dir}/read.vcf", "-writeVcf", "-"], tmp)
    assert _strip_pbwt_headers(out) == read(f"{ref_test_dir}/write.vcf")


def test_reference_impute(ref_test_dir, tmp):
    """test_pbwt_reference_impute (test.pl:201-207)."""
    pbwt(["-readVcfGT", f"{ref_test_dir}/OMNI.vcf", "-writeAll", f"{tmp}/OMNI"], tmp)
    out, _ = pbwt(["-readVcfGT", f"{ref_test_dir}/refImpute.in.vcf",
                   "-referenceImpute", f"{tmp}/OMNI", "-writeVcf", "-"], tmp)
    assert _strip_pbwt_headers(out) == read(f"{ref_test_dir}/refImpute.out.vcf")


def test_merge(ref_test_dir, tmp):
    """test_merge + test_merge_sites (test.pl:209-221)."""
    for name in ("merge.1", "merge.2"):
        pbwt(["-readVcfq", f"{ref_test_dir}/{name}.tab",
              "-write", f"{tmp}/{name}.pbwt",
              "-writeSites", f"{tmp}/{name}.sites"], tmp)
    out, _ = pbwt(["-merge", f"{tmp}/merge.1.pbwt", f"{tmp}/merge.2.pbwt",
                   "-write", f"{tmp}/merged.pbwt",
                   "-writeSites", f"{tmp}/merge.12.sites"], tmp)
    pbwt(["-read", f"{tmp}/merged.pbwt", "-haps", f"{tmp}/merge.12.out"], tmp)
    assert read(f"{tmp}/merge.12.out") == read(f"{ref_test_dir}/merge.12.out")
    assert read(f"{tmp}/merge.12.sites") == read(f"{ref_test_dir}/merge.12.sites")


def test_profile_trace(ref_test_dir, tmp):
    """-profile <dir> (SURVEY.md section 5 tracing): the rest of the command
    pipeline runs under jax.profiler.start_trace and a trace directory with
    at least one .xplane.pb event file appears."""
    pbwt(["-readVcfq", f"{ref_test_dir}/merge.1.tab",
          "-write", f"{tmp}/merge.1.pbwt"], tmp)
    pbwt(["-profile", f"{tmp}/trace", "-read", f"{tmp}/merge.1.pbwt",
          "-buildReverse", "-haps", f"{tmp}/rev.out"], tmp)
    found = []
    for root, _, files in os.walk(f"{tmp}/trace"):
        found += [f for f in files if f.endswith(".xplane.pb")]
    assert found, "no xplane trace events written by -profile"
