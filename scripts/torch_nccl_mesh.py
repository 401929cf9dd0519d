"""Every multi-rank path of the port over NCCL, one card a rank, on one
machine of four cards, each held against the same path over gloo.

Its parts, in this order:

  edits    ``chip_smoke.py`` phase 9 as it is (its rank groups and jobs:
           world 2 with toy_model, toy_data, full_model, shapes_model2,
           toy_photo_model; world 4 with toy_hybrid, full_hybrid,
           shapes_model4, toy_photo_hybrid), its ranks
           over NCCL with rank r on cuda:r: its bars (40 dB against the
           unsharded edit on one card, the collective log against
           ``collectives.expected_counts``, K1/K6 at local shapes, every
           bf16 launch on the tensor cores) and 9c's kernel checks at every
           shape its one-step edits launched in each mode. Then the jobs
           with images again over gloo with the ranks sharing cuda:0, and
           the PSNR between the two. No collective may stage through host
           memory (``collectives._staged``), and every one must run.
  apps     ``python -m blobctrl_torch.apps.cli`` at ``--mesh
           data=1,model=4`` and at ``--mesh data=2,model=2
           --hybrid_cfg_data`` with ``--device cuda``, against the same
           argv with ``--device cpu`` (gloo), fp32 on the trained 256^2
           toy as a models root; ``apps.server.start_mesh(root, "cuda",
           "data=2,model=2", ...)``: a solo request and a batch of four,
           against the same requests on the CPU's gloo mesh, then a
           refused request (an unknown scheduler) and a good one without a
           seed. The images are held to the uint8 bar of
           ``tests/test_torch_parallel_apps.py``.
  train    ``apps.train_cli --data_parallel 4 --device cuda`` (the spawned
           form: one process, rank r on cuda:r), recorded in fp32 by
           ``tests/torch_ranks.py``, against the same argv with ``--device
           cpu`` at ``chip_smoke.py`` 10d's bars: every rank's examples,
           rows and t bit-equal, losses within 1e-4, first gradients within
           1e-3 of each leaf's max, the checkpoints through
           ``chip_smoke.hosts_state_check``, the collective log
           ``train_step.training_counts``'.
  photo    full-width one-step sharded edits at a photo's size, 768x512
           (``chip_smoke.PHOTO``, W x H; bf16, phase 9b's weights drawn a
           rank), over NCCL, rank r on cuda:r: model=2, model=4 and hybrid
           2 x 2 (``chip_smoke.PHOTO_SHARDED``), each rank's image >= 40 dB
           (phase 9's bar) from the same edit unsharded on one card, its
           collective log equal to ``collectives.expected_counts``, every
           bf16 launch on the tensor cores, no collective staged through
           host memory.
  measure  printed, not held to a bar: seconds per 512^2 standard edit
           (``benchkit.standard_edit_kwargs(512, 10)``, bf16, phase 9b's
           weights drawn once a rank) on 1 card, at model=2, model=4 and
           hybrid 2 x 2, every layout alive at once and the edits
           interleaved rep by rep, warm medians of ``EDIT_REPS`` (the cold
           first edit apart); 10b's full-width training step at 4 ranks:
           its seconds, the seconds inside ``train_step.mean_over_ranks``
           between two device syncs, the peak memory a rank.

Run from the repository root on a machine with 4 cards:

  python scripts/torch_nccl_mesh.py [--out chiprun_out/nccl_mesh.json]

It prints the card's name and power limit and every reading, and writes
them as JSON to --out. Exit code 1 where a rank fails or a check fails."""

import argparse
import base64
import collections
import json
import multiprocessing
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WORLD = 4                  # ranks, one card each
CARD = "cuda"              # the ranks' device: rank r on cuda:r
PARTS = ("edits", "apps", "train", "photo", "measure")   # run in this order
APP_STEPS = 4              # the apps' toy edits
APP_BATCH = 4              # the server's batch
APP_PROMPT = "a red ball"
APP_ELLIPSE = (166.4, 140.8, 76.8, 102.4, 20.0)  # toy_edits' destination
APP_MESHES = ((["--mesh", "data=1,model=4"], "model=4"),
              (["--mesh", "data=2,model=2", "--hybrid_cfg_data"], "hybrid"))
SERVE_MESH = "data=2,model=2"
EDIT_STEPS = 10            # part 4's edit, chip_smoke.py's STEPS
EDIT_REPS = 3              # warm edits a layout
# part 4's layouts: (name, ranks, mesh shape, recipe)
LAYOUTS = (("1 card", 1, None, None),
           ("model=2", 2, {"data": 1, "model": 2}, "model"),
           ("model=4", 4, {"data": 1, "model": 4}, "model"),
           ("hybrid 2x2", 4, {"data": 2, "model": 2}, "hybrid"))


def log(*args):
    print(*args, flush=True)


def _join_group(rank, world, port):
    """Rank ``rank`` of ``world`` over nccl on cuda:rank."""
    from blobctrl_torch.parallel import multihost
    return multihost.initialize(f"127.0.0.1:{port}", world, rank,
                                device=CARD, backend="nccl",
                                timeout_s=cs.PARALLEL_TIMEOUT_S)


# ---------------------------------------------------------------------------
# part 1: phase 9's sharded edits over nccl
# ---------------------------------------------------------------------------

def sharded_edits():
    """Part 1. -> its report; AssertionError where a bar fails."""
    nccl, staging, real = {}, [], cs.spawn_ranks

    def over_nccl(world, jobs, meanwhile=None, device=None):
        ranks = real(world, jobs, device=CARD, backend="nccl")
        for job in jobs:
            nccl[job] = [r[job] for r in ranks]
        staging.extend(r[cs.STAGING] for r in ranks)
        return ranks

    log("  phase 9 below runs its ranks over NCCL, rank r on cuda:r, where "
        "its lines say gloo on one card; the seconds of a group's first "
        "edit include its communicators' set-up")
    cs.spawn_ranks = over_nccl
    try:
        launched = cs.parallel_phase({k: {} for k in cs.ALL_KERNELS})
    finally:
        cs.spawn_ranks = real
    log(f"  collectives a rank (calls, staged through host memory): "
        f"{staging}")
    if any(s[1] or not s[0] for s in staging):
        raise AssertionError(f"a collective staged through host memory, "
                             f"or a rank ran none: {staging}")
    report = {"launches": launched, "staging": staging, "jobs": {}}
    for world, jobs in cs.PARALLEL_GROUPS:
        imaged = [j for j in jobs if nccl[j][0]["images"] is not None]
        t0 = time.perf_counter()
        gloo = cs.spawn_ranks(world, imaged)
        log(f"  {world} ranks sharing cuda:0 over gloo ran "
            f"{', '.join(imaged)} in {time.perf_counter() - t0:.1f} s")
        for job in imaged:
            psnrs = [cs.psnr(n["images"], g[job]["images"])
                     for n, g in zip(nccl[job], gloo)]
            secs = [n["secs"] for n in nccl[job]]
            report["jobs"][job] = {
                "psnr_nccl_vs_gloo": psnrs, "nccl_secs": secs,
                "gloo_secs": [g[job]["secs"] for g in gloo],
                "peak_gib": [n["peak_gib"] for n in nccl[job]],
                "collectives": nccl[job][0]["collectives"]}
            log(f"  {job}: PSNR of the NCCL ranks' images against the "
                f"gloo ranks' on one card "
                f"{', '.join(f'{p:.2f}' for p in psnrs)} dB; seconds "
                f"{', '.join(f'{s:.3f}' for s in secs)} over NCCL, "
                f"{', '.join(f'{g[job]['secs']:.3f}' for g in gloo)} "
                f"over gloo on one card")
    log("  launches of the sharded runs over NCCL, summed over ranks: "
        + json.dumps(launched))
    return report


# ---------------------------------------------------------------------------
# part photo: full-width sharded edits at a photo's size
# ---------------------------------------------------------------------------

def photo_edits():
    """Part photo. -> its report; AssertionError where a bar fails."""
    import gc
    from blobctrl_torch.apps import flagship
    from blobctrl_torch.parallel import collectives
    from blobctrl_torch.pipeline.blobnet_pipeline import blobnet_keep_schedule
    from blobctrl_torch.utils import benchkit
    kw = cs.parallel_edits()["photo_one_step"]
    pipe = benchkit.make_flagship_pipe(seed=0, device="cuda:0",
                                       dtype=torch.bfloat16)
    ref, secs = cs.timed(lambda: pipe(**kw).images)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  the one-step edit at {cs.PHOTO[0]}x{cs.PHOTO[1]} (W x H) "
        f"unsharded on cuda:0: {secs:.3f} s")
    fcfg = (flagship.sd15_unet_config(), flagship.blobctrl_blobnet_config(),
            flagship.sd15_vae_config())
    blobnet_steps = int(blobnet_keep_schedule(
        1, 0.0, kw["blobnet_control_guidance_end"]).sum())
    report, failed = {}, []
    for world in (2, 4):
        jobs = [j for j, (shape, _) in cs.PHOTO_SHARDED.items()
                if shape["data"] * shape["model"] == world]
        t0 = time.perf_counter()
        ranks = cs.spawn_ranks(world, jobs, device=CARD, backend="nccl")
        log(f"  {world} ranks over NCCL ran {', '.join(jobs)} in "
            f"{time.perf_counter() - t0:.1f} s (spawn, draws and shard "
            f"included)")
        staging = [r[cs.STAGING] for r in ranks]
        if any(st[1] or not st[0] for st in staging):
            failed.append(f"world {world}: staged or no collective "
                          f"{staging}")
        for job in jobs:
            shape, recipe = cs.PHOTO_SHARDED[job]
            expected = collectives.expected_counts(
                *fcfg, shape, recipe, 1, blobnet_steps=blobnet_steps)
            cell = report[job] = {"psnr": [], "secs": [], "peak_gib": []}
            for rank, r in enumerate(ranks):
                run = r[job]
                p = cs.psnr(run["images"], ref)
                cell["psnr"].append(p)
                cell["secs"].append(run["secs"])
                cell["peak_gib"].append(run["peak_gib"])
                log(f"  {job} rank {rank}: PSNR against the unsharded edit "
                    f"{p:.2f} dB (bar {cs.PARALLEL_BAR_DB:.0f}), "
                    f"{run['secs']:.3f} s, peak memory "
                    f"{run['peak_gib']:.2f} GiB, launches "
                    f"{ {k: run['launches'][k] for k in cs.EXACT} }, "
                    f"collectives {run['counts']}")
                try:
                    cs.check_tensor_cores(f"{job} rank {rank}",
                                          run["launches"], cs.EXACT,
                                          run["tc"])
                except AssertionError as e:
                    failed.append(str(e))
                if run["images"].shape != ref.shape \
                        or not p >= cs.PARALLEL_BAR_DB:
                    failed.append(f"{job} rank {rank}: "
                                  f"{run['images'].shape}, {p} dB")
                if run["counts"] != expected:
                    failed.append(f"{job} rank {rank}: collectives "
                                  f"{run['counts']} != {expected}")
    if failed:
        raise AssertionError("; ".join(failed))
    return report


# ---------------------------------------------------------------------------
# part 2: the CLI and the server as a user starts them
# ---------------------------------------------------------------------------

def u8_distance(a, b) -> dict:
    """The uint8 bar of ``tests/test_torch_parallel_apps.py``: <= 1 level
    at >= 99.9 % of the pixels, <= 2 everywhere; a and b in [0, 1]."""
    qa = np.round(np.asarray(a) * 255).astype(np.int32)
    qb = np.round(np.asarray(b) * 255).astype(np.int32)
    d = np.abs(qa - qb)
    share = float((d <= 1).mean())
    return {"max": int(d.max()), "within_1": share,
            "ok": bool(d.max() <= 2 and share >= 0.999)}


def write_app_inputs(work):
    """The toy move edit's object and background as PNG files -> paths."""
    from blobctrl_torch.utils import png
    move = cs.toy_edits(cs.DP_HOST_SIZE, APP_STEPS)["move"]
    paths = {}
    for name in ("fg_image", "bg_image"):
        paths[name] = os.path.join(work, f"{name}.png")
        with open(paths[name], "wb") as f:
            f.write(png.encode_png(move[name]))
    return paths


def cli_argv(models, paths, out, device):
    return ["--models_root", models, "--object_image", paths["fg_image"],
            "--edited_background", paths["bg_image"], "--scene_prompt",
            APP_PROMPT, "--ellipse", ",".join(map(str, APP_ELLIPSE)),
            "--dtype", "f32", "--num_inference_steps", str(APP_STEPS),
            "--seed", "0", "--output_dir", out, "--device", device]


def run_clis(models, paths, work, timeout):
    """The CLI at each of APP_MESHES on the cards and on the CPU, the two
    at once. -> {mesh: report}; AssertionError where one fails."""
    from blobctrl_torch.utils import png
    ranks = cs.tests_module("torch_ranks")
    threads = str(max(1, (os.cpu_count() or 8) // (2 * WORLD)))
    report = {}
    for flags, name in APP_MESHES:
        outs = {d: os.path.join(work, f"cli_{name}_{d}")
                for d in (CARD, "cpu")}
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "blobctrl_torch.apps.cli",
             *cli_argv(models, paths, outs[d], d), *flags], cwd=ROOT,
            env=dict(os.environ, OMP_NUM_THREADS=threads),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for d in (CARD, "cpu")]
        done = ranks.wait_processes(procs, timeout)
        secs = time.perf_counter() - t0
        for (rc, text), d in zip(done, (CARD, "cpu")):
            if rc:
                log(f"  the CLI at {name} on {d} failed:\n{text[-3000:]}")
                raise AssertionError(f"the CLI at {name} on {d}: exit {rc}")
        lines = [json.loads(x) for x in done[0][1].splitlines()
                 if x.startswith("{")]
        images = {}
        for d in (CARD, "cpu"):
            with open(os.path.join(outs[d], "edit_0.png"), "rb") as f:
                images[d] = png.decode_png(f.read()) / 255.0
        bar = u8_distance(images[CARD], images["cpu"])
        report[name] = {"bar": bar, "seconds_both": secs, "lines": lines}
        log(f"  cli {' '.join(flags)}: --device {CARD} against --device "
            f"cpu: max {bar['max']} levels, {100 * bar['within_1']:.3f} % "
            f"within 1 ({'ok' if bar['ok'] else 'FAIL'}); its lines "
            f"{lines}; both in {secs:.1f} s")
        if not bar["ok"]:
            raise AssertionError(f"cli at {name}: {bar}")
    return report


def _post(url, payload):
    code, body = cs._http(url + "/v1/edit", payload)
    return code, json.loads(body)


def _payload(paths, seed, **kw):
    def b64(path):
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()
    return dict(prompt=APP_PROMPT, fg_image=b64(paths["fg_image"]),
                bg_image=b64(paths["bg_image"]), ellipse=list(APP_ELLIPSE),
                seed=seed, size=cs.DP_HOST_SIZE,
                num_inference_steps=APP_STEPS, **kw)


def _images(resp):
    from blobctrl_torch.utils import png
    return np.stack([png.decode_png(base64.b64decode(b)) / 255.0
                     for b in resp["images"]])


def serve_requests(models, paths, device):
    """A mesh server at SERVE_MESH on ``device`` (this process rank 0):
    a solo request, a batch of APP_BATCH at once, a refused request, a
    good one without a seed. -> what it answered; AssertionError where a
    status or the mesh is not as it must be."""
    from blobctrl_torch.apps import server
    t0 = time.perf_counter()
    pipe = server.start_mesh(models, device, SERVE_MESH, False,
                             dtype=torch.float32,
                             timeout_s=cs.PARALLEL_TIMEOUT_S)
    start = time.perf_counter() - t0
    svc, httpd = server.serve(pipe, "127.0.0.1", 0, size=cs.DP_HOST_SIZE,
                              warmup_steps=None, max_batch=APP_BATCH,
                              batch_window_ms=1500.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    got = {"start_s": start}
    try:
        t0 = time.perf_counter()
        code, solo = _post(url, _payload(paths, 3))
        got["solo_s"] = time.perf_counter() - t0
        batch = [None] * APP_BATCH

        def one(i):
            batch[i] = _post(url, _payload(paths, 10 + i))
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(APP_BATCH)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        got["batch_s"] = time.perf_counter() - t0
        refused = _post(url, _payload(paths, 3, scheduler="nope"))
        good = _post(url, _payload(paths, None))
        codes = [code] + [c for c, _ in batch] + [refused[0], good[0]]
        got["codes"] = codes
        got["batch_sizes"] = [r.get("batch_size") for _, r in batch]
        if codes != [200] * (1 + APP_BATCH) + [400, 200]:
            raise AssertionError(f"server on {device}: status codes {codes}"
                                 f" ({refused[1]}, {good[1].get('error')})")
        got["solo"] = _images(solo)
        got["batch"] = [_images(r) for _, r in batch]
        got["failed"] = pipe.failed
    finally:
        httpd.shutdown()
        svc.close()   # joins the followers, leaves the group
    codes = got["follower_codes"] = [p.exitcode
                                     for p in pipe.followers.procs]
    if got["failed"] is not None or any(c != 0 for c in codes):
        raise AssertionError(f"server on {device}: the mesh failed "
                             f"({got['failed']}), followers {codes}")
    return got


def serve_both(models, paths):
    """The server on the CPU's gloo mesh, then over NCCL. -> report."""
    runs = {}
    for d in ("cpu", CARD):
        runs[d] = serve_requests(models, paths, d)
        log(f"  server at {SERVE_MESH} on {d}: status codes "
            f"{runs[d]['codes']}, batch sizes {runs[d]['batch_sizes']}; "
            f"started in {runs[d]['start_s']:.1f} s, solo "
            f"{runs[d]['solo_s']:.3f} s, batch of {APP_BATCH} "
            f"{runs[d]['batch_s']:.3f} s (client seconds)")
    bars = {"solo": u8_distance(runs[CARD]["solo"], runs["cpu"]["solo"])}
    for i in range(APP_BATCH):
        bars[f"batch_{i}"] = u8_distance(runs[CARD]["batch"][i],
                                         runs["cpu"]["batch"][i])
    log(f"  server over NCCL against the CPU's mesh: " + ", ".join(
        f"{k} max {b['max']} ({100 * b['within_1']:.3f} % within 1)"
        for k, b in bars.items()))
    if not all(b["ok"] for b in bars.values()):
        raise AssertionError(f"server: {bars}")
    return {"bars": bars, **{d: {k: v for k, v in r.items()
                                 if k not in ("solo", "batch")}
                             for d, r in runs.items()}}


def apps(work, timeout):
    """Part 2. -> its report."""
    models = os.path.join(work, "roots", "models")
    paths = write_app_inputs(work)
    return {"cli": run_clis(models, paths, work, timeout),
            "server": serve_both(models, paths)}


# ---------------------------------------------------------------------------
# part 3: spawned data-parallel training
# ---------------------------------------------------------------------------

def train_argv(roots, ckpt_dir, device):
    """10d's flags and roots with the global batch of its 2 hosts of 2
    ranks, as one host's --batch_size, over WORLD spawned ranks."""
    argv = cs.hosts_argv(roots, ckpt_dir)
    argv[argv.index("--batch_size") + 1] = str(cs.DP_HOSTS
                                               * cs.DP_HOST_BATCH)
    return argv + ["--data_parallel", str(WORLD), "--device", device]


def spawned_training(work, timeout):
    """Part 3. -> its report; AssertionError where a bar fails."""
    from blobctrl_torch.parallel import multihost
    from blobctrl_torch.train import checkpoint as ckpt_lib
    from blobctrl_torch.train import train_step as ts
    ranks = cs.tests_module("torch_ranks")
    roots = os.path.join(work, "roots")
    dirs = {d: os.path.join(work, f"train_{d}") for d in (CARD, "cpu")}
    t0 = time.perf_counter()
    procs = []
    for d, path in dirs.items():
        os.makedirs(os.path.join(path, "records"))
        procs.append(ranks.start_host(
            train_argv(roots, os.path.join(path, "ckpts"), d),
            os.path.join(path, "records")))
    done = ranks.wait_processes(procs, timeout)
    secs = time.perf_counter() - t0
    for (rc, text), d in zip(done, dirs):
        if rc:
            log(f"  training on {d} failed:\n{text[-3000:]}")
            raise AssertionError(f"training on {d}: exit {rc}")
    recs = {}
    for d, path in dirs.items():
        recs[d] = []
        for g in range(WORLD):
            with open(os.path.join(path, "records", f"rank{g}.pkl"),
                      "rb") as f:
                recs[d].append(pickle.load(f))
    got, want = (ckpt_lib.restore(os.path.join(dirs[d], "ckpts"),
                                  device="cpu") for d in (CARD, "cpu"))
    counts = ts.training_counts(got["params"], WORLD,
                                steps=cs.DP_HOST_STEPS, replicated=got,
                                checkpoints=1)
    batch = cs.DP_HOSTS * cs.DP_HOST_BATCH
    report, ok = {"seconds_both": secs, "ranks": []}, True
    for g, (n, c) in enumerate(zip(recs[CARD], recs["cpu"])):
        rel = max(abs(x - y) / abs(y) for x, y in zip(
            n["steps"]["loss"], c["steps"]["loss"]))
        grads = cs.worst_leaf(n["steps"]["grads"][0],
                              c["steps"]["grads"][0])
        rows = [[d[1].start, d[1].stop] for d in n["draws"]]
        mine = multihost.local_rows(batch, WORLD, g)
        same = (n["seen"] == c["seen"]
                and rows == [[d[1].start, d[1].stop] for d in c["draws"]]
                and rows == [[mine.start, mine.stop]] * cs.DP_HOST_STEPS
                and all(np.array_equal(x[2], y[2])
                        for x, y in zip(n["draws"], c["draws"])))
        good = (same and len(n["steps"]["loss"]) == cs.DP_HOST_STEPS
                and rel <= cs.TOL[torch.float32] and grads <= 1e-3
                and n["sizes"] == counts and c["sizes"] == counts)
        ok &= good
        line = {"rank": g, "examples": n["seen"], "rows": rows,
                "loss": n["steps"]["loss"], "cpu_loss": c["steps"]["loss"],
                "loss_rel": rel, "grads_rel": grads,
                "collectives": n["sizes"], "ok": good}
        report["ranks"].append(line)
        log("  " + json.dumps(line))
    held, report["state"] = cs.hosts_state_check(
        got, want, recs[CARD][0]["steps"]["grads"],
        recs["cpu"][0]["steps"]["grads"])
    log("  " + cs.hosts_state_reading(report["state"]))
    ok &= got["step"] == cs.DP_HOST_STEPS and held
    log(f"  train_cli --data_parallel {WORLD} over NCCL and over gloo on "
        f"the CPU, both at once: {secs:.1f} s; "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("spawned data-parallel training")
    return report


# ---------------------------------------------------------------------------
# part 4: what the parallel layer had never measured
# ---------------------------------------------------------------------------

def _layout_rank(rank, world, port, shape, recipe, cmds, out):
    """One rank of a part-4 layout: phase 9b's weights, sharded; then an
    edit for each command until None, its seconds and peak memory (and
    rank 0's first images) put on ``out``."""
    try:
        from blobctrl_torch.parallel import mesh as mesh_lib
        from blobctrl_torch.parallel import multihost
        from blobctrl_torch.utils import benchkit
        if world > 1:
            _join_group(rank, world, port)
        else:
            torch.cuda.set_device(0)
        pipe = benchkit.make_flagship_pipe(seed=0, device="cuda",
                                           dtype=torch.bfloat16)
        if recipe:
            pipe.shard_to_mesh(mesh_lib.make_mesh(**shape),
                               model_parallel=True,
                               hybrid_cfg_data=recipe == "hybrid")
        kw = dict(benchkit.standard_edit_kwargs(512, EDIT_STEPS), seed=0)
        out.put((rank, "ok", "ready"))
        first = True
        while cmds.get() is not None:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images = pipe(**kw).images
            torch.cuda.synchronize()
            out.put((rank, "ok", {
                "secs": time.perf_counter() - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "images": images if first and rank == 0 else None}))
            first = False
        multihost.shutdown()
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))


def free_ports(n: int):
    """n distinct free TCP ports below the ephemeral range, which the many
    connections of part 4's processes draw from while they start."""
    import random
    import socket
    ports = []
    while len(ports) < n:
        port = random.randrange(20000, 30000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        if port not in ports:
            ports.append(port)
    return ports


class Layout:
    """A part-4 layout's ranks, alive until ``close``."""

    def __init__(self, ctx, name, world, shape, recipe, port):
        self.name, self.world = name, world
        self.out = ctx.Queue()
        self.cmds = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_layout_rank, args=(
            r, world, port, shape, recipe, self.cmds[r], self.out))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, deadline_s):
        """Every rank's next result, in rank order."""
        try:
            return cs.collect(self.out, self.procs, deadline_s)
        except AssertionError as e:
            raise AssertionError(f"{self.name}: {e}") from None

    def edit(self, deadline_s):
        for q in self.cmds:
            q.put("edit")
        return self.results(deadline_s)

    def close(self):
        for q in self.cmds:
            q.put(None)
        cs.join(self.procs)


def _train_rank(rank, world, port, out):
    """10b on a rank of ``world`` over nccl (one row a rank), the seconds
    inside ``mean_over_ranks`` between two device syncs recorded."""
    try:
        from blobctrl_torch.parallel import multihost
        from blobctrl_torch.train import train_step as ts
        _join_group(rank, world, port)
        cs.DP_WORLD = cs.DP_FULL_BATCH = world
        real, inside = ts.mean_over_ranks, []

        def timed(grads, loss, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = real(grads, loss, group)
            torch.cuda.synchronize()
            inside.append(time.perf_counter() - t0)
            return got
        ts.mean_over_ranks = timed
        try:
            res = cs._dp_full(cs.DP_SEED)
        finally:
            ts.mean_over_ranks = real
            multihost.shutdown()
        steps = [{k: s[k] for k in ("secs", "loss", "grad_norm", "sizes",
                                    "launches")} for s in res["steps"]]
        out.put((rank, "ok", {"steps": steps, "mean_s": inside,
                              "peak_gib": res["peak_gib"],
                              "digest": res["digest"]}))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))


def measure():
    """Part 4: printed, not held to a bar. -> its report."""
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    layouts = [Layout(ctx, *spec, port) for spec, port in zip(
        LAYOUTS, free_ports(len(LAYOUTS)))]
    times = collections.defaultdict(list)
    report = {"edit": {}, "train": None}
    try:
        for lay in layouts:
            lay.results(cs.PARALLEL_TIMEOUT_S)
        log(f"  {len(layouts)} layouts ({sum(x.world for x in layouts)} "
            f"processes) drew and sharded their weights in "
            f"{time.perf_counter() - t0:.1f} s")
        images = {}
        for rep in range(1 + EDIT_REPS):    # the first edit is cold
            for lay in layouts:
                res = lay.edit(cs.PARALLEL_TIMEOUT_S)
                times[lay.name].append(res)
                if res[0]["images"] is not None:
                    images[lay.name] = res[0]["images"]
    finally:
        for lay in layouts:
            lay.close()
    for lay in layouts:
        reps = times[lay.name]
        warm = [r[0]["secs"] for r in reps[1:]]
        cell = {"ranks": lay.world, "cold_s": reps[0][0]["secs"],
                "warm_s": warm, "median_s": statistics.median(warm),
                "peak_gib": [max(r[k]["peak_gib"] for r in reps)
                             for k in range(lay.world)],
                "psnr_vs_1_card": cs.psnr(images[lay.name],
                                          images[LAYOUTS[0][0]])}
        report["edit"][lay.name] = cell
        log(f"  512^2 edit, {EDIT_STEPS} steps, bf16, {lay.name}: warm median "
            f"{cell['median_s']:.3f} s of {[round(x, 3) for x in warm]}, "
            f"cold {cell['cold_s']:.3f} s, peak memory a rank "
            f"{[round(x, 2) for x in cell['peak_gib']]} GiB, PSNR against "
            f"the 1-card edit {cell['psnr_vs_1_card']:.2f} dB")
    t0 = time.perf_counter()
    ranks = cs.spawn(_train_rank, WORLD, ())
    train = {"seconds": time.perf_counter() - t0, "ranks": ranks,
             "same_state": len({r["digest"] for r in ranks}) == 1}
    report["train"] = train
    for r, res in enumerate(ranks):
        log(f"  10b at {WORLD} ranks over NCCL, rank {r}: step seconds "
            f"{[round(s['secs'], 3) for s in res['steps']]}, inside the "
            f"gradient mean {[round(x, 3) for x in res['mean_s']]} s, "
            f"losses {[round(s['loss'], 6) for s in res['steps']]}, peak "
            f"memory {res['peak_gib']:.2f} GiB, all-reduces a step "
            f"{res['steps'][0]['sizes'].get('pipeline', {})}")
    log(f"  10b: every rank's final parameters the same: "
        f"{train['same_state']}; {train['seconds']:.1f} s with set-up")
    return report


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a part's processes may take")
    a = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(card)
    if torch.cuda.device_count() < WORLD:
        log(f"needs {WORLD} cards, {torch.cuda.device_count()} visible")
        return 1
    work = tempfile.mkdtemp(prefix="nccl_mesh_")
    try:
        return run(a, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(a, card, work):
    from blobctrl_torch.ops import _build
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    cs.EXP_RATE = (torch.cuda.get_device_properties(0).multi_processor_count
                   * cs.EXP_PER_SM_CLOCK * clock_mhz * 1e6)
    t0 = time.perf_counter()
    _build.build_all()   # once, before the ranks load the kernels
    log(f"kernel build {time.perf_counter() - t0:.1f} s")
    cs.write_hosts_roots(os.path.join(work, "roots"))
    steps = {"edits": sharded_edits, "measure": measure,
             "photo": photo_edits,
             "apps": lambda: apps(work, a.timeout),
             "train": lambda: spawned_training(work, a.timeout)}
    report, failed = {"card": card, "parts": {}}, []
    for part in PARTS:
        log(f"part {part}")
        t0 = time.perf_counter()
        got = {}
        try:
            got = steps[part]()
        except Exception:  # noqa: BLE001 — the next part runs all the same
            log(traceback.format_exc())
            failed.append(part)
        got["seconds"] = time.perf_counter() - t0
        report["parts"][part] = got
        log(f"part {part}: {'FAILED' if part in failed else 'ok'} in "
            f"{got['seconds']:.1f} s")
    report["failed"] = failed
    report["ok"] = not failed
    log(json.dumps({"ok": report["ok"], "failed": failed, "seconds": {
        p: round(r["seconds"], 1) for p, r in report["parts"].items()}}))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1, default=repr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
