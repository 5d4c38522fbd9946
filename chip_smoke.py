"""On-chip smoke test: the device engine on one GPU, checked against the
host C engine (or numpy where the C engine has no entry) in one process.

Phases, one line each with host and device wall times, the card and the
result of each exact comparison:

  device          platform, device_kind, count, bytes_limit, card
  site_step       the plain site step == engine.forwards_ad on random words
                  with all-zero and all-one key columns at M = 100,000 and
                  1,048,576; the one-hot gathers exact at 2^20 values;
                  per-site times of the two partition forms (cumsum +
                  scatter, the library's; stable 4-operand sort) and of the
                  two word gathers (take, the library's; two stable sorts),
                  and the one-hot gather beside jnp.take at Q=4096, M=100k
  build           PBWT.from_haplotypes at 100,000 x 2,048 through the
                  device route: yz bytes and aFend == the native C build
  match_standing  the -matchDynamic route on that panel with 256 mosaic
                  queries: stdout bytes == the host sweep
  match_1m        DeviceMatcher at 1,048,576 x 2,048, Q=256, on the
                  resident trajectory and on the forced segment path: rows
                  == the C sweep's rows
  impute          -referenceImpute through pbwt_tpu.cli.main: a 20,000-
                  haplotype reference and 2,000 targets typed at a
                  4,000-site frame, .haps bytes == the host route
  opt_in          paint at 2,000 x 3,000 within 2e-4 of the host; the
                  copy-model likelihood at M=2,048, N=512 within 1e-4
                  relative (the device accumulates in f32)

Exits non-zero without a GPU backend, on any mismatch and on any
exception; the last line of stdout is {"ok": true, "device": {...}}.

Usage: python chip_smoke.py [phase ...]     (default: every phase)
"""

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import pbwt_tpu  # noqa: F401  (fails first when run outside the repo)

# shapes of each phase (the smoke test's workload, not options)
SITE_MS = (100_000, 1 << 20)
GATHER_QM = (4096, 100_000)
PANEL = (100_000, 2048, 256)             # M, N, Q
BIG = (1 << 20, 2048, 256)
IMPUTE = (22_000, 16_000, 20_000, 4_000)  # M, N, reference haps, frame
PAINT = (2_000, 3_000)
LL = (2_048, 512)
STANDING_ROWS_SEEN = 15_642  # earlier record for PANEL's generator

CARD = ""


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def report(phase, **fields):
    print(f"{phase}: {json.dumps({**fields, 'card': CARD})}", flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def route(value):
    """PBWT_TPU_DEVICE for the block: "0" host, "1" device, None default."""
    prev = os.environ.get("PBWT_TPU_DEVICE")
    if value is None:
        os.environ.pop("PBWT_TPU_DEVICE", None)
    else:
        os.environ["PBWT_TPU_DEVICE"] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("PBWT_TPU_DEVICE", None)
        else:
            os.environ["PBWT_TPU_DEVICE"] = prev


@contextlib.contextmanager
def counting(owner, name):
    """Record the wall time of each call to ``owner.name`` inside the block:
    the proof of which route a comparison's side took (a module function or
    a class method, looked up at call time by the routing sites), and how
    much of the route's time that entry takes."""
    calls = []
    orig = getattr(owner, name)

    def wrapped(*args, **kwargs):
        out, dt = timed(lambda: orig(*args, **kwargs))
        calls.append(dt)
        return out

    setattr(owner, name, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def routed(value, owner, name, fn, phase):
    """Time ``fn`` under ``route(value)`` and check that the device entry
    ``owner.name`` ran on the device side and did not on the host side.
    Returns (output, wall seconds, seconds inside the device entry)."""
    with route(value), counting(owner, name) as calls:
        out, dt = timed(fn)
    check(bool(calls) == (value != "0"),
          f"{phase}: {name} ran {len(calls)} times under "
          f"PBWT_TPU_DEVICE={value}")
    return out, dt, sum(calls)


def median_time(fn, reps=5):
    """Median wall time of ``fn`` (which blocks on its result), warm."""
    fn()
    ts = []
    for _ in range(reps):
        _, dt = timed(fn)
        ts.append(dt)
    return float(np.median(ts))


# ---------------------------------------------------------------- forms
# The alternatives the library does not use, kept here to time against it.

def site_step_sort(a, d, w, s, k):
    """The site step with the partition as one stable 4-operand sort."""
    import jax
    import jax.numpy as jnp

    from pbwt_tpu.ops.build import _segmented_running_max

    key = jax.lax.shift_right_logical(w, s) & 1
    mask0 = key == 0
    r0 = jnp.cumsum(mask0, dtype=jnp.int32)
    kk = jnp.asarray(k, d.dtype)
    prev0 = jnp.concatenate([jnp.zeros(1, bool), mask0[:-1]])
    prev1 = jnp.concatenate([jnp.zeros(1, bool), ~mask0[:-1]])
    seed = d.at[0].max(kk + 1)
    pq = jnp.where(mask0, _segmented_running_max(seed, prev0),
                   _segmented_running_max(seed, prev1))
    _, a2, d2, w2 = jax.lax.sort((key, a, pq, w), num_keys=1, is_stable=True)
    return a2, d2.at[0].set(kk + 2), w2, r0 - mask0, r0[-1]


def gather_two_sorts(w_nat, a):
    """w_nat[a] as two stable sorts (inverse permutation, then payload)."""
    import jax
    import jax.numpy as jnp

    iota = jnp.arange(a.shape[0], dtype=jnp.int32)
    _, inv = jax.lax.sort((a, iota), num_keys=1, is_stable=True)
    _, r = jax.lax.sort((inv, w_nat), num_keys=1, is_stable=True)
    return r


# --------------------------------------------------------------- phases

def phase_device(td):
    import jax

    dev = jax.devices()[0]
    report("device", platform=dev.platform, kind=dev.device_kind,
           count=len(jax.devices()),
           bytes_limit=dev.memory_stats()["bytes_limit"])


def _site_parity(M):
    """Four chained site steps on device == engine.forwards_ad."""
    import jax
    import jax.numpy as jnp

    from pbwt_tpu.core import engine
    from pbwt_tpu.ops.build import site_step

    rng = np.random.RandomState(M)
    w = rng.randint(0, 2 ** 32, size=M, dtype=np.uint64).astype(np.uint32)
    w = ((w & ~np.uint32(3)) | np.uint32(2)).view(np.int32)  # bit0 0s, bit1 1s
    a = rng.permutation(M).astype(np.int32)
    d = np.zeros(M + 1, np.int32)
    d[:M] = rng.randint(0, 40, size=M)
    step = jax.jit(site_step)
    aj, dj, wj = jnp.asarray(a), jnp.asarray(d[:M]), jnp.asarray(w)
    t_host = t_dev = 0.0
    for s, k in [(0, 40), (1, 41), (2, 42), (31, 43)]:
        out, dt = timed(lambda: jax.block_until_ready(step(aj, dj, wj, s, k)))
        t_dev += dt
        key = ((w.view(np.uint32) >> s) & 1).astype(np.uint8)
        (a, d), dt = timed(lambda: engine.forwards_ad(a, d, key, k))
        t_host += dt
        order = np.concatenate([np.flatnonzero(key == 0),
                                np.flatnonzero(key == 1)])
        u_ref = np.concatenate([[0], np.cumsum(key == 0)])[:M]
        w = w[order]
        a2, d2, w2, u, c = (np.asarray(x) for x in out)
        check(np.array_equal(a2, a), f"site_step a at M={M} s={s}")
        check(np.array_equal(d2, d[:M]), f"site_step d at M={M} s={s}")
        check(np.array_equal(w2, w), f"site_step w at M={M} s={s}")
        check(np.array_equal(u, u_ref), f"site_step u at M={M} s={s}")
        check(int(c) == int((key == 0).sum()), f"site_step c at M={M} s={s}")
        aj, dj, wj = out[:3]
    return t_host, t_dev


def _chain_time(step_fn, M):
    """Seconds per site of a jitted 32-site chain of ``step_fn``."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(1)
    a = jnp.asarray(rng.permutation(M).astype(np.int32))
    d = jnp.asarray(rng.randint(0, 100, size=M).astype(np.int32))
    w = jnp.asarray(rng.randint(0, 2 ** 32, size=M, dtype=np.uint64)
                    .astype(np.uint32).view(np.int32))

    @jax.jit
    def chain(a, d, w):
        def body(s, st):
            a, d, w, acc = st
            a, d, w, u, c = step_fn(a, d, w, s, s + 100)
            return a, d, w, acc + u[-1] + c
        return jax.lax.fori_loop(0, 32, body, (a, d, w, jnp.int32(0)))

    out = chain(a, d, w)
    return median_time(lambda: jax.block_until_ready(chain(a, d, w))) / 32, out


def _gather_time(gather_fn, M):
    """Seconds per gather of a jitted chain of 32 word gathers."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    a = jnp.asarray(rng.permutation(M).astype(np.int32))
    w = jnp.asarray(rng.randint(0, 1 << 30, size=M).astype(np.int32))

    @jax.jit
    def chain(w, a):
        return jax.lax.fori_loop(0, 32, lambda i, w: gather_fn(w, a), w)

    out = chain(w, a)
    return median_time(lambda: jax.block_until_ready(chain(w, a))) / 32, out


def _onehot_exact():
    """The one-hot gathers are exact for values far above bf16's 2^8."""
    import jax.numpy as jnp

    from pbwt_tpu.ops import match_jax as mj

    rng = np.random.RandomState(11)
    R = 64
    plane = rng.randint(0, 1 << 20, size=(R, 128)).astype(np.int32)
    flat = plane.reshape(-1)
    idx = rng.randint(0, R * 128, size=96).astype(np.int32)
    planes = mj._u8_digit_planes(jnp.asarray(plane))
    got8 = np.asarray(mj._mxu_gather_u8planes(planes, jnp.asarray(idx)))
    check(np.array_equal(got8, flat[idx]), "digit-plane gather inexact")
    start = rng.randint(-4, R * 128 - 1, size=96).astype(np.int32)
    two, l0 = (np.asarray(x) for x in
               mj._mxu_window_rows(planes, jnp.asarray(start)))
    for j in range(mj._WW):
        li = l0 + j
        pos = start + j
        ok = (li < 256) & (pos >= 0) & (pos < R * 128)
        check(np.array_equal(two[ok, li[ok]], flat[pos[ok]]),
              f"window rows inexact at j={j}")


def _onehot_vs_take():
    """FM-step lookups at Q=4096 (2Q indices), M=100k: the bf16 digit-plane
    one-hot gather vs jnp.take on an int32 table; both exact."""
    import jax
    import jax.numpy as jnp

    from pbwt_tpu.ops import match_jax as mj
    from pbwt_tpu.ops.build import pad_to

    Q, M = GATHER_QM
    Mp = pad_to(M)
    rng = np.random.RandomState(3)
    table = rng.randint(0, M + 1, size=Mp).astype(np.int32)
    idx = jnp.asarray(rng.randint(0, Mp, size=2 * Q).astype(np.int32))
    tab = jnp.asarray(table)
    planes = mj._u8_digit_planes(tab.reshape(-1, 128))

    def looped(fn, t):
        @jax.jit
        def run(t, idx):
            return jax.lax.fori_loop(
                0, 32, lambda i, acc: acc + fn(t, (idx + i) % Mp),
                jnp.zeros(idx.shape, jnp.int32))
        out = run(t, idx)
        return (median_time(lambda: jax.block_until_ready(run(t, idx))) / 32,
                np.asarray(out))

    t_oh, got_oh = looped(mj._mxu_gather_u8planes, planes)
    t_take, got_take = looped(lambda t, i: jnp.take(t, i), tab)
    want = sum(table[(np.asarray(idx) + i) % Mp].astype(np.int64)
               for i in range(32))
    check(np.array_equal(got_oh, want), "one-hot FM gather inexact")
    check(np.array_equal(got_take, want), "take FM gather inexact")
    return t_oh, t_take


def phase_site_step(td):
    from pbwt_tpu.ops.build import gather_words, site_step

    for M in SITE_MS:
        t_host, t_dev = _site_parity(M)
        t_scatter, out_s = _chain_time(site_step, M)
        t_sort, out_o = _chain_time(site_step_sort, M)
        check(all(np.array_equal(np.asarray(x), np.asarray(y))
                  for x, y in zip(out_s, out_o)), f"forms differ at M={M}")
        t_take, g1 = _gather_time(gather_words, M)
        t_2sort, g2 = _gather_time(gather_two_sorts, M)
        check(np.array_equal(np.asarray(g1), np.asarray(g2)),
              f"gathers differ at M={M}")
        report("site_step", M=M, exact=True, host_s=t_host, device_s=t_dev,
               cumsum_scatter_us_per_site=1e6 * t_scatter,
               sort_us_per_site=1e6 * t_sort,
               take_gather_us=1e6 * t_take, two_sort_gather_us=1e6 * t_2sort)
    _onehot_exact()
    t_oh, t_take = _onehot_vs_take()
    report("site_step", onehot_exact_2e20=True, Q=GATHER_QM[0],
           M=GATHER_QM[1], onehot_gather_us=1e6 * t_oh,
           take_gather_us=1e6 * t_take)


_panel_cache = {}


def _standing_panel():
    """PANEL's haplotypes and their host-built PBWTs (shared by phases)."""
    if not _panel_cache:
        from pbwt_tpu.core.pbwt import PBWT
        from pbwt_tpu.ops import build
        from pbwt_tpu.synth import match_data

        M, N, Q = PANEL
        Xp, Xq = match_data(M, N, Q)
        (p, q), t, _ = routed("0", build, "build_pbwt_device",
                              lambda: (PBWT.from_haplotypes(Xp),
                                       PBWT.from_haplotypes(Xq)), "build")
        _panel_cache.update(Xp=Xp, Xq=Xq, p=p, q=q, t_host_build=t)
    return _panel_cache


def phase_build(td):
    from pbwt_tpu.core.pbwt import PBWT
    from pbwt_tpu.ops import build

    panel = _standing_panel()
    Xp, p_host = panel["Xp"], panel["p"]

    def device():
        return routed(None, build, "build_pbwt_device",
                      lambda: PBWT.from_haplotypes(Xp), "build")

    p_cold, t_cold, _ = device()
    p_warm, t_warm, e_warm = device()
    for p in (p_cold, p_warm):
        check(p.yz == p_host.yz, "build: yz bytes differ from the C build")
        check(np.array_equal(p.aFend, p_host.aFend), "build: aFend differs")
    report("build", M=Xp.shape[0], N=Xp.shape[1], exact=True,
           host_s=panel["t_host_build"], device_cold_s=t_cold,
           device_warm_s=t_warm, warm_in_device_entry_s=e_warm,
           yz_bytes=len(p_host.yz))


def _sweep_stdout(p, q, path):
    from pbwt_tpu.algos import match as am

    with open(path, "w") as f, contextlib.redirect_stdout(f):
        am.match_sequences_sweep(p, q, am.report_match_stdout)
    with open(path, "rb") as f:
        return f.read()


def phase_match_standing(td):
    from pbwt_tpu.ops.match_jax import DeviceMatcher

    panel = _standing_panel()
    p, q = panel["p"], panel["q"]

    def sweep(value, tag):
        return routed(value, DeviceMatcher, "match",
                      lambda: _sweep_stdout(p, q, f"{td}/{tag}.txt"),
                      "matchDynamic")

    host, t_host, _ = sweep("0", "host")
    cold, t_cold, _ = sweep(None, "dev")
    warm, t_warm, e_warm = sweep(None, "dev")
    check(cold == host and warm == host,
          "matchDynamic: device stdout differs from the host sweep")
    rows = host.count(b"\n")
    report("match_standing", M=p.M, N=p.N, Q=q.M, exact=True, rows=rows,
           rows_earlier_record=STANDING_ROWS_SEEN, host_s=t_host,
           device_cold_s=t_cold, device_warm_s=t_warm,
           warm_in_matcher_match_s=e_warm)


def _row_set(rows):
    rows = np.asarray(rows, np.int64).reshape(-1, 4)
    rows = rows[rows[:, 2] != rows[:, 3]]
    return rows[np.lexsort(rows.T[::-1])]


def phase_match_1m(td):
    import jax

    from pbwt_tpu.algos import match as am
    from pbwt_tpu.core.pbwt import PBWT
    from pbwt_tpu.ops.match_jax import DeviceMatcher
    from pbwt_tpu.synth import match_data

    M, N, Q = BIG
    Xp, Xq = match_data(M, N, Q)
    with route("0"):
        p = PBWT.from_haplotypes(Xp)
        q = PBWT.from_haplotypes(Xq)
    host, t_host = timed(lambda: _row_set(am.match_sequences_sweep_rows(p, q)))
    del p, q
    for path, traj_bytes in (("resident", None), ("segment", 0)):
        m, t_init = timed(lambda: DeviceMatcher(Xp, traj_bytes=traj_bytes))
        check((m.traj is not None) == (traj_bytes is None),
              f"match_1m: {path} path not taken")
        cold, t_cold = timed(lambda: _row_set(m.match(Xq)))
        warm, t_warm = timed(lambda: _row_set(m.match(Xq)))
        check(np.array_equal(cold, host) and np.array_equal(warm, host),
              f"match_1m: {path} rows differ from the C sweep")
        del m
        gc.collect()
        report("match_1m", path=path, M=M, N=N, Q=Q, exact=True,
               rows=len(host), host_s=t_host, device_init_s=t_init,
               device_cold_s=t_cold, device_warm_s=t_warm,
               peak_bytes_in_use=jax.devices()[0].memory_stats()[
                   "peak_bytes_in_use"])


def _write_impute_inputs(td):
    """The panel as .pbwt/.sites, then reference, targets and frame."""
    from pbwt_tpu import cli
    from pbwt_tpu.core import registry
    from pbwt_tpu.core.pbwt import PBWT, Site
    from pbwt_tpu.io import pbwtfile
    from pbwt_tpu.synth import beta_panel

    M, N, Mref, Nframe = IMPUTE
    rng = np.random.RandomState(111)
    X = beta_panel(M, N, rng)
    pos = np.sort(rng.choice(np.arange(1, 10_000_000), N, replace=False))
    registry.init()
    als = ["A\tC", "A\tG", "C\tT", "G\tT"]
    p = PBWT.from_haplotypes(X, chrom="20")
    p.sites = [Site(x=int(pos[k]), varD=registry.variation_dict.add(
        als[k % 4])) for k in range(N)]
    with open(f"{td}/all.pbwt", "wb") as f:
        pbwtfile.write_pbwt(p, f)
    with open(f"{td}/all.sites", "w") as f:
        pbwtfile.write_sites(p, f)
    del X, p
    for args in (["-readAll", f"{td}/all", "-subsample", "0", str(Mref),
                  "-writeAll", f"{td}/refpan"],
                 ["-readAll", f"{td}/all", "-subsample", str(Mref),
                  str(M - Mref), "-writeAll", f"{td}/tgt_full"]):
        check(cli.main(args) == 0, f"impute setup: {args}")
    with open(f"{td}/tgt_full.sites") as f:
        lines = f.readlines()
    keep = np.sort(rng.choice(N, Nframe, replace=False))
    with open(f"{td}/frame.sites", "w") as f:
        f.writelines([lines[i] for i in keep])
    check(cli.main(["-readAll", f"{td}/tgt_full", "-selectSites",
                    f"{td}/frame.sites", "-writeAll", f"{td}/tgt"]) == 0,
          "impute setup: selectSites")


def phase_impute(td):
    from pbwt_tpu import cli
    from pbwt_tpu.ops import impute_jax

    _write_impute_inputs(td)

    def run(tag):
        out = f"{td}/{tag}.haps"
        check(cli.main(["-readAll", f"{td}/tgt", "-referenceImpute",
                        f"{td}/refpan", "-haps", out]) == 0,
              f"referenceImpute ({tag}) failed")
        with open(out, "rb") as f:
            return f.read()

    host, t_host, _ = routed("0", impute_jax, "impute_dosages_device",
                             lambda: run("host"), "referenceImpute")
    dev, t_dev, e_dev = routed(None, impute_jax, "impute_dosages_device",
                               lambda: run("dev"), "referenceImpute")
    check(dev == host, "referenceImpute: .haps bytes differ from the host")
    M, N, Mref, Nframe = IMPUTE
    report("impute", ref_haps=Mref, targets=M - Mref, sites=N, frame=Nframe,
           exact=True, haps_bytes=len(host), host_s=t_host, device_s=t_dev,
           in_device_entry_s=e_dev)


def phase_opt_in(td):
    from pbwt_tpu.algos import likelihood, paint
    from pbwt_tpu.core.pbwt import PBWT
    from pbwt_tpu.ops import likelihood_jax, paint_jax
    from pbwt_tpu.synth import beta_panel

    M, N = PAINT
    p = PBWT.from_haplotypes(beta_panel(M, N, np.random.RandomState(5)))
    files = ("chunkcounts.out", "chunklengths.out",
             "regionsquaredchunkcounts.out", "regionchunkcounts.out")
    times, worst = {}, 0.0
    for tag, env in (("host", "0"), ("dev", "1")):
        _, times[tag], e_dev = routed(
            env, paint_jax, "paint_totals_device",
            lambda: paint.paint_ancestry_matrix(p, f"{td}/{tag}", 5), "paint")
    for name in files:
        with open(f"{td}/host.{name}") as f:
            a = f.read().split()
        with open(f"{td}/dev.{name}") as f:
            b = f.read().split()
        check(len(a) == len(b), f"paint {name}: shape differs")
        for x, y in zip(a, b):
            if x != y:
                worst = max(worst, abs(float(x) - float(y)))
    # f32 device accumulation: a printed digit may differ on half-ulp ties
    check(worst <= 2e-4, f"paint differs by {worst} > 2e-4")
    report("opt_in", what="paint", M=M, N=N, max_abs_diff=worst,
           tolerance=2e-4, host_s=times["host"], device_s=times["dev"],
           in_device_entry_s=e_dev)

    M, N = LL
    p = PBWT.from_haplotypes(beta_panel(M, N, np.random.RandomState(6)))

    def copy_ll(value):
        return routed(value, likelihood_jax, "copy_ll_device",
                      lambda: likelihood.copy_log_likelihood_drop_one(
                          p, 0.08, 0.03), "copy_ll")

    host, t_host, _ = copy_ll("0")
    dev, t_dev, _ = copy_ll("1")
    rel = abs(dev - host) / abs(host)
    check(rel <= 1e-4, f"copy-model LL rel diff {rel} > 1e-4")
    report("opt_in", what="copy_ll", M=M, N=N, rel_diff=rel, tolerance=1e-4,
           host_s=t_host, device_s=t_dev)


PHASES = ("device", "site_step", "build", "match_standing", "match_1m",
          "impute", "opt_in")


def main(argv):
    global CARD
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
                 f"not a GPU")
    todo = argv or list(PHASES)
    check(set(todo) <= set(PHASES), f"unknown phase in {todo}")
    from pbwt_tpu.ops import enable_compile_cache

    enable_compile_cache()
    CARD = card_info()
    print(CARD, flush=True)
    with tempfile.TemporaryDirectory() as td:
        for name in PHASES:
            if name not in todo:
                continue
            _, dt = timed(lambda: globals()[f"phase_{name}"](td))
            print(f"# {name} took {dt:.1f} s", file=sys.stderr, flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main(sys.argv[1:])
