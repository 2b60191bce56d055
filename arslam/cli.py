"""``arslam`` command-line interface.

Subcommands mirror the reference CLIs (SURVEY.md §2.1):

- ``arslam map [map.yaml ...] img...``      ≙ ar_slam_cli (batch mapping;
  modes: images only / re-solve saved map / map + new images,
  ar_slam_cli.cpp:40-54).  Always writes map.yaml (cwd by default).
- ``arslam localize map.yaml [inputs...]``  ≙ ar_loc; writes localize.yaml.
- ``arslam gen``                            ≙ ar_gen tag sheets.
- ``arslam detect img...``                  detection only, prints JSON.
- ``arslam serve``                          incremental mapping loop fed by
  a watched directory or stdin filenames (≙ the component pipeline +
  load_images service).
- ``arslam replay log.jsonl``               rebuild a map from an event log
  (≙ bag replay workflow).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def _is_yaml(fn: str) -> bool:
    return fn.endswith((".yaml", ".yml"))



def _maybe_print_metrics(args, engine) -> None:
    """--metrics: per-stage counters/timings (SURVEY §5.5 observability)."""
    if getattr(args, "metrics", False):
        print(json.dumps({"metrics": engine.metrics.summary()}),
              file=sys.stderr)


def cmd_map(args) -> int:
    from arslam.pipeline.engine import ArSlamEngine

    engine = ArSlamEngine(config=_config(args),
                          use_device_detector=not args.cpu_detector)
    images = []
    for fn in args.inputs:
        if _is_yaml(fn):
            engine.load_map(fn)
        else:
            images.append(fn)
    if images:
        engine.add_images(images)
    summary = engine.solve()
    engine.print_cameras()
    engine.save_map(args.output)
    print(f"solved {summary.get('waves', 0)} captures, "
          f"rmse {summary.get('rmse', float('nan')):.4f} px -> {args.output}")
    _maybe_print_metrics(args, engine)
    return 0


def cmd_localize(args) -> int:
    from arslam.pipeline.engine import ArSlamEngine

    engine = ArSlamEngine(config=_config(args),
                          use_device_detector=not args.cpu_detector)
    engine.load_map(args.map)
    images = []
    for fn in args.inputs:
        if _is_yaml(fn):
            engine.load_map(fn)
        else:
            images.append(fn)
    result = engine.localize(images)
    engine.print_cameras()
    engine.save_map(args.output)
    for uid, status in result.get("status", {}).items():
        print(f"{uid}: {status}")
    print(f"localized {result.get('localized', 0)} captures, "
          f"rmse {result.get('rmse', float('nan')):.4f} px -> {args.output}")
    _maybe_print_metrics(args, engine)
    return 0


def cmd_gen(args) -> int:
    from arslam.detect.gen import generate_pages

    paths = generate_pages(args.out_dir, args.dictionary)
    for p in paths:
        print(p)
    return 0


def cmd_detect(args) -> int:
    from arslam.pipeline.engine import ArSlamEngine

    mesh = None
    n_dev = getattr(args, "devices", None)
    if n_dev and n_dev > 1:
        from arslam.parallel.detect import image_mesh

        mesh = image_mesh(n_dev)
    engine = ArSlamEngine(config=_config(args),
                          use_device_detector=not args.cpu_detector,
                          detect_mesh=mesh)
    for uid, dets, size, _path in engine.detect_images(args.inputs):
        print(json.dumps({
            "uid": uid,
            "width": size[0],
            "height": size[1],
            "detections": [
                {"id": tid, "corners": c.reshape(-1).tolist()}
                for tid, c in dets
            ],
        }))
    _maybe_print_metrics(args, engine)
    return 0


def cmd_serve(args) -> int:
    """Incremental mapping: read image paths (one per line) from stdin or
    watch a directory; solve incrementally after each batch; save the map
    on shutdown (≙ ArSlam node lifecycle ar_slam.cpp:103-111).

    Default mode is PIPELINED: decode, device detection, the merge join and
    the incremental solve overlap through double-buffered queues, ≙ the
    reference's multithreaded component container
    (ar_slam_launch.py:124-142); --sequential restores the strict
    poll→detect→solve loop.  With --artifacts FILE every solved batch
    appends one jsonl record of TF/CameraInfo/markers (≙ the per-batch
    publishes at ar_slam.cpp:133-155); --debug-images DIR writes an
    annotated PNG per newly solved capture (≙ displayDebug per solve,
    ar_slam_util.cpp:982-998, headless)."""
    import time

    from arslam.pipeline.engine import ArSlamEngine

    engine = ArSlamEngine(config=_config(args),
                          use_device_detector=not args.cpu_detector)
    if args.map and os.path.exists(args.map):
        engine.load_map(args.map)
    emit = _serve_artifact_emitter(args, engine)
    pipe = None
    if not args.sequential:
        from arslam.pipeline.stream import StreamPipeline

        pipe = StreamPipeline(engine, on_solve=emit)

    def handle(batch):
        if pipe is not None:
            pipe.submit(batch)
            return "pipelined"
        before = engine.store.next_capture_index
        engine.add_images(batch)
        s = engine.solve_incremental()
        uids = [c.uid for c in engine.store.captures[before:]]
        emit(s, uids)
        return s

    seen = set()
    server = None
    if args.listen:
        from arslam.pipeline.service import LoadImagesServer

        server = LoadImagesServer(args.listen)
        print(f"load_images service on {args.listen}")
    try:
        if args.watch or server is not None:
            if args.watch:
                print(f"watching {args.watch} (ctrl-c to stop)")
            while True:
                batch = []
                if args.watch:
                    for fn in sorted(os.listdir(args.watch)):
                        p = os.path.join(args.watch, fn)
                        if p not in seen and fn.lower().endswith(
                                (".jpg", ".jpeg", ".png")):
                            seen.add(p)
                            batch.append(p)
                if server is not None:
                    batch.extend(server.pop_batch())
                if batch:
                    s = handle(batch)
                    print(f"+{len(batch)} images: {s}")
                if pipe is not None:
                    pipe.poll()
                if server is not None:
                    if pipe is not None and server.has_make_map():
                        pipe.drain()  # make-map answers see a settled store
                    for respond, fns in server.pop_make_map():
                        respond(_make_map_response(args, fns))
                time.sleep(args.poll)
        else:
            for line in sys.stdin:
                fn = line.strip()
                if not fn:
                    continue
                s = handle([fn])
                print(f"{fn}: {s}")
    except KeyboardInterrupt:
        pass
    finally:
        if pipe is not None:
            try:
                last = pipe.drain()
                if last is not None:
                    print(f"final: {last}")
            finally:
                pipe.close()
        if server is not None:
            server.close()
        if args.output:
            engine.save_map(args.output)
        engine.close()
        _maybe_print_metrics(args, engine)
    return 0


def _serve_artifact_emitter(args, engine):
    """Build the per-solve artifact callback: jsonl TF/CameraInfo/marker
    stream (--artifacts) + annotated debug PNGs (--debug-images)."""
    import json as _json
    import time as _time

    art_path = getattr(args, "artifacts", "")
    dbg_dir = getattr(args, "debug_images", "")
    if dbg_dir:
        os.makedirs(dbg_dir, exist_ok=True)

    def emit(summary, uids):
        if not (art_path or dbg_dir):
            return
        if art_path:
            art = engine.export_artifacts()
            rec = {
                "t": _time.time(),
                "solved_uids": list(uids),
                "summary": {k: (float(v) if hasattr(v, "__float__") else v)
                            for k, v in (summary or {}).items()
                            if not isinstance(v, dict)},
                **art,
            }
            with open(art_path, "a") as f:
                f.write(_json.dumps(rec) + "\n")
        if dbg_dir:
            from arslam.pipeline.ingest import load_image
            from arslam.viz.annotate import annotate_capture

            for uid in uids:
                idx = engine.store.capture_map.get(uid)
                if idx is None:
                    continue
                cap = engine.store.captures[idx]
                if not cap.img_fn or not os.path.exists(cap.img_fn):
                    continue
                img = load_image(cap.img_fn)
                out = os.path.join(dbg_dir, f"{uid}_annotated.png")
                annotate_capture(engine.store, idx, img, out,
                                 show_all_tags=True)

    return emit


def cmd_load_images(args) -> int:
    """Send filenames to a running ``arslam serve --listen`` instance
    (≙ load_images_client, ar_slam_module.py:8-20)."""
    from arslam.pipeline.service import send_load_images

    if not args.inputs:
        print("error: no image filenames given", file=sys.stderr)
        return 1
    resp = send_load_images(args.sock, args.inputs)
    print(resp.get("message", ""))
    return 0 if resp.get("success") else 1


def _make_map_response(args, fns: list[str]) -> dict:
    """Fulfil one MakeMap request: build a standalone map from the given
    images and return its YAML text (≙ MakeMap.srv: img_fns -> yaml —
    declared by the reference interfaces but never served there)."""
    import io

    from arslam.pipeline.engine import ArSlamEngine

    try:
        eng = ArSlamEngine(config=_config(args),
                           use_device_detector=not args.cpu_detector)
        from arslam.graph import save_yaml

        eng.add_images(fns)
        summary = eng.solve()
        buf = io.StringIO()
        save_yaml(eng.store, buf)
        return {"success": True,
                "message": f"solved {summary.get('waves', 0)} captures, "
                           f"rmse {summary.get('rmse', float('nan')):.4f} px",
                "yaml": buf.getvalue()}
    except Exception as e:  # noqa: BLE001 — report failure to the client
        return {"success": False, "message": f"make_map failed: {e}"}


def cmd_make_map(args) -> int:
    """One-shot MakeMap request against a running serve instance."""
    from arslam.pipeline.service import send_make_map

    if not args.inputs:
        print("error: no image filenames given", file=sys.stderr)
        return 1
    resp = send_make_map(args.sock, args.inputs, timeout=args.timeout)
    print(resp.get("message", ""), file=sys.stderr)
    if not resp.get("success"):
        return 1
    if args.output:
        with open(args.output, "w") as f:
            f.write(resp.get("yaml", ""))
    else:
        sys.stdout.write(resp.get("yaml", ""))
    return 0


def cmd_replay(args) -> int:
    """Rebuild a map from an event log.  Default: replay the recorded
    detections (self-contained — corners are in the log).  With
    --redetect: decode the EMBEDDED images (serve --embed-images /
    PipelineConfig.event_log_embed_images, ≙ the bag storing full Capture
    messages, bag_recorder.cpp:73-83) and re-run the detector."""
    from arslam.pipeline.engine import (ArSlamEngine, EventLog,
                                             decode_png_b64)
    from arslam.pipeline.ingest import IngestedCapture
    import numpy as np

    engine = ArSlamEngine(config=_config(args))
    if getattr(args, "redetect", False):
        caps = []
        for rec in EventLog.replay(args.log):
            if rec["kind"] != "capture":
                continue
            if "image_png" not in rec:
                print(f"error: capture {rec['uid']} has no embedded image "
                      "(record with serve --embed-images)", file=sys.stderr)
                return 1
            caps.append(IngestedCapture(
                uid=rec["uid"], path=rec.get("path", ""),
                image=decode_png_b64(rec["image_png"])))
        for uid, by_dict, size, path in engine.detect_decoded(caps):
            flat = [d for dets in by_dict.values() for d in dets]
            engine.store.add_detections(uid, flat, size, path)
    else:
        for rec in EventLog.replay(args.log):
            if rec["kind"] != "detections":
                continue
            dets = [(d["id"], np.asarray(d["corners"]).reshape(4, 2))
                    for d in rec["detections"]]
            engine.store.add_detections(rec["uid"], dets,
                                        (rec["width"], rec["height"]),
                                        rec.get("path", ""))
    summary = engine.solve()
    engine.save_map(args.output)
    print(f"replayed -> rmse {summary.get('rmse', float('nan')):.4f} px "
          f"-> {args.output}")
    _maybe_print_metrics(args, engine)
    return 0


def cmd_annotate(args) -> int:
    """Write annotated debug images (≙ displayDebug, headless)."""
    import numpy as np

    from arslam.graph import MapStore, load_yaml
    from arslam.pipeline.ingest import load_image
    from arslam.viz.annotate import annotate_capture

    store = MapStore()
    load_yaml(store, args.map)
    os.makedirs(args.out_dir, exist_ok=True)
    for cap in store.captures:
        if not cap.img_fn or not os.path.exists(cap.img_fn):
            continue
        img = load_image(cap.img_fn)
        out = os.path.join(args.out_dir, f"{cap.uid}_annotated.png")
        annotate_capture(store, cap.index, img, out,
                         show_all_tags=args.all_tags)
        print(out)
    return 0


def cmd_audit(args) -> int:
    """Per-block reprojection audit (≙ compareProjections,
    ar_slam_util.cpp:576-589): worst blocks first."""
    from arslam.graph import MapStore, load_yaml
    from arslam.utils.audit import compare_projections, format_audit

    store = MapStore()
    load_yaml(store, args.map)
    rows = compare_projections(store)
    if args.json:
        for d in rows:
            print(json.dumps(d))
    else:
        print(format_audit(rows, limit=args.limit))
    return 0


def cmd_scene(args) -> int:
    """Render the 3-D map scene (≙ the Foxglove 3D panel, headless)."""
    from arslam.graph import MapStore, load_yaml
    from arslam.viz.scene import render_scene

    store = MapStore()
    load_yaml(store, args.map)
    out = render_scene(store, args.output)
    print(out)
    return 0


def _config(args):
    from arslam.config import ArSlamConfig, SolverConfig, CameraConfig
    import dataclasses

    cfg = ArSlamConfig()
    cfg_fn = getattr(args, "config", "")
    if cfg_fn:
        import yaml

        with open(cfg_fn) as f:
            cfg = ArSlamConfig.from_dict(yaml.safe_load(f) or {})
    if getattr(args, "parity", False):
        cfg = dataclasses.replace(
            cfg,
            solver=dataclasses.replace(cfg.solver, seed_mode="frontal",
                                       seed_anchors="single",
                                       localize_unknown_tags=True),
            camera=dataclasses.replace(cfg.camera, focal_init_mode="fixed"),
        )
    n_dev = getattr(args, "devices", None)
    if n_dev is not None:
        cfg = dataclasses.replace(
            cfg, dist=dataclasses.replace(
                cfg.dist, num_devices=n_dev if n_dev > 1 else 0)
        )
    if getattr(args, "distortion", False):
        cfg = dataclasses.replace(
            cfg,
            camera=dataclasses.replace(cfg.camera, enable_distortion=True),
        )
    pub_period = getattr(args, "pub_period", None)
    if pub_period is not None:
        cfg = dataclasses.replace(
            cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                              pub_period=pub_period))
    event_log = getattr(args, "event_log", None)
    if event_log:
        cfg = dataclasses.replace(
            cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                              event_log_path=event_log))
    if getattr(args, "embed_images", False):
        cfg = dataclasses.replace(
            cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                              event_log_embed_images=True))
    loss = getattr(args, "robust_loss", "")
    if loss:
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver, loss=loss))
    loss_scale = getattr(args, "loss_scale", None)
    if loss_scale is not None:
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver,
                                            loss_scale=loss_scale))
    if getattr(args, "progress", False):
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(
                cfg.solver, minimizer_progress_to_stdout=True))
    if getattr(args, "iterative_schur", False):
        cfg = dataclasses.replace(
            cfg,
            solver=dataclasses.replace(cfg.solver, linear_solver="cg"),
        )
    every = getattr(args, "optimize_every", None)
    if every is not None and every >= 1:
        cfg = dataclasses.replace(
            cfg,
            solver=dataclasses.replace(cfg.solver, optimize_every=every),
        )
    max_side = getattr(args, "max_side", None)
    if max_side is not None:
        cfg = dataclasses.replace(
            cfg,
            detect=dataclasses.replace(cfg.detect, max_side=max_side),
        )
    dicts = getattr(args, "dictionaries", "")
    if dicts:
        names = tuple(d.strip() for d in dicts.split(",") if d.strip())
        from arslam.detect.dictionaries import DICT_NAMES

        for n in names:
            if n not in DICT_NAMES:
                raise SystemExit(
                    f"unknown dictionary {n!r}; choose from {DICT_NAMES}")
        cfg = dataclasses.replace(
            cfg,
            detect=dataclasses.replace(cfg.detect, dictionaries=names),
            pipeline=dataclasses.replace(
                cfg.pipeline,
                expected_detector_types=tuple(f"aruco_{n}" for n in names),
            ),
        )
    prof = getattr(args, "profile", "")
    if prof:
        cfg = dataclasses.replace(
            cfg,
            pipeline=dataclasses.replace(cfg.pipeline,
                                         profile_trace_dir=prof),
        )
    return cfg


CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_compile_cache() -> str:
    """Persistent XLA compilation cache, so repeat invocations skip the
    jit compiles.  ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads
    it itself); otherwise the cache sits at a fixed path inside the
    checkout — the path is part of the cache key, so it must not move.
    Returns the directory in use."""
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(levelname)s] %(name)s: %(message)s",
    )
    _enable_compile_cache()
    p = argparse.ArgumentParser(prog="arslam",
                                description="AR-tag SLAM engine")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default="",
                        help="YAML/JSON file with the full ArSlamConfig "
                             "tree (CLI flags override it)")
        sp.add_argument("--metrics", action="store_true",
                        help="print the per-stage metrics summary (counts "
                             "and timings) as JSON on stderr at exit")
        sp.add_argument("--cpu-detector", action="store_true",
                        help="use the NumPy oracle detector instead of the "
                             "batched device detector")
        sp.add_argument("--parity", action="store_true",
                        help="reference-parity mode: fixed focal init 3000 "
                             "+ frontal-only seeding + localization "
                             "includes map-unknown tags at constant zero "
                             "poses (ar_slam_util.cpp:950-972)")
        sp.add_argument("--devices", type=int, default=None,
                        help="shard the solve over N devices (distributed "
                             "BA over a 'blocks' mesh); 0/1 = single device")
        sp.add_argument("--multihost", default="",
                        help="join a multi-controller runtime before "
                             "solving: 'coordinator:port,num_processes,"
                             "process_id' (explicit) or 'auto' (cluster "
                             "autodetect, e.g. SLURM); the mesh then spans every "
                             "process's devices and --devices defaults to "
                             "the global device count (≙ the reference's "
                             "DDS data plane, SURVEY §2.3/§5.8)")
        sp.add_argument("--platform", default="",
                        help="force a jax platform (e.g. 'cpu' for "
                             "multi-host simulation on one machine)")
        sp.add_argument("--profile", default="",
                        help="write a jax profiler trace (xprof/tensorboard"
                             ") of the solve to this directory")
        sp.add_argument("--distortion", action="store_true",
                        help="calibrate radial distortion l1,l2 (the model "
                             "the reference carries but leaves disabled); "
                             "use on both map and localize runs")
        sp.add_argument("--dictionaries", default="",
                        help="comma-separated dictionaries to detect "
                             "(default 4X4_50,5X5_100; also 6X6_250 — the "
                             "three the reference's aruco_dict param "
                             "accepts)")
        sp.add_argument("--max-side", type=int, default=None,
                        help="detection working resolution: downscale "
                             "larger images before the detector, corners "
                             "reported at full resolution (0 = off)")
        sp.add_argument("--robust-loss", default="",
                        help="robust loss: 'huber' downweights outlier "
                             "observations (the reference uses none)")
        sp.add_argument("--loss-scale", type=float, default=None,
                        help="Huber delta in pixels of block residual norm")
        sp.add_argument("--iterative-schur", action="store_true",
                        help="solve the reduced camera system with "
                             "implicit-Schur preconditioned CG instead of "
                             "dense Cholesky (faster at large capture "
                             "counts; ≙ ceres ITERATIVE_SCHUR)")
        sp.add_argument("--progress", action="store_true",
                        help="print one line per LM iteration "
                             "(host-stepped; ≙ ceres "
                             "minimizer_progress_to_stdout)")
        sp.add_argument("--optimize-every", type=int, default=None,
                        help="run the full optimization only every Nth "
                             "capture wave (always the last) instead of "
                             "the reference's per-capture re-solve; large "
                             "batch-mapping speedup at equal final RMSE")

    sp = sub.add_parser("map", help="batch mapping (≙ ar_slam_cli)")
    sp.add_argument("inputs", nargs="+",
                    help="mix of map .yaml checkpoints and images")
    sp.add_argument("-o", "--output", default="map.yaml")
    common(sp)
    sp.set_defaults(fn=cmd_map)

    sp = sub.add_parser("localize", help="localize against a map (≙ ar_loc)")
    sp.add_argument("map", help="map.yaml to localize against")
    sp.add_argument("inputs", nargs="+", help="images (or more yaml)")
    sp.add_argument("-o", "--output", default="localize.yaml")
    common(sp)
    sp.set_defaults(fn=cmd_localize)

    sp = sub.add_parser("gen", help="generate printable tag sheets (≙ ar_gen)")
    sp.add_argument("--dictionary", default="4X4_50")
    sp.add_argument("--out-dir", default=".")
    sp.set_defaults(fn=cmd_gen)

    sp = sub.add_parser("detect", help="detect markers, print JSON")
    sp.add_argument("inputs", nargs="+")
    common(sp)  # --devices = shard the image batch (data-parallel detect)
    sp.set_defaults(fn=cmd_detect)

    sp = sub.add_parser("serve", help="incremental mapping loop")
    sp.add_argument("--map", default="", help="initial map.yaml to extend")
    sp.add_argument("-o", "--output", default="map.yaml")
    sp.add_argument("--watch", default="", help="directory to watch")
    sp.add_argument("--poll", type=float, default=0.5)
    sp.add_argument("--listen", default="",
                    help="unix socket path for the load_images service "
                         "(clients: arslam load-images --sock PATH img...)")
    sp.add_argument("--sequential", action="store_true",
                    help="disable the overlapped ingest/detect/merge/solve "
                         "pipeline (strict poll-detect-solve loop)")
    sp.add_argument("--pub-period", type=float, default=None,
                    help="pace ingest to one image per PERIOD seconds "
                         "(the reference ImageLoader's pub_period, default "
                         "0.5 there; 0/omitted = unthrottled)")
    sp.add_argument("--event-log", default=None,
                    help="append captures+detections to this jsonl event "
                         "log (≙ BagRecorder; replay with arslam replay)")
    sp.add_argument("--embed-images", action="store_true",
                    help="embed capture pixels (base64 PNG) in the event "
                         "log — hermetic replay without the originals "
                         "(≙ the bag storing full Capture messages)")
    sp.add_argument("--artifacts", default="",
                    help="append one jsonl record of TF/CameraInfo/markers "
                         "per solved batch (≙ the per-batch publishes, "
                         "ar_slam.cpp:133-155)")
    sp.add_argument("--debug-images", default="", dest="debug_images",
                    help="write an annotated PNG per newly solved capture "
                         "into this directory (≙ per-solve displayDebug)")
    common(sp)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("load-images",
                        help="send images to a running serve instance "
                             "(≙ load_images_client)")
    sp.add_argument("inputs", nargs="*", help="image filenames")
    sp.add_argument("--sock", default="/tmp/arslam.sock")
    sp.set_defaults(fn=cmd_load_images)

    sp = sub.add_parser("make-map",
                        help="one-shot map build via a running serve "
                             "(≙ MakeMap.srv: img_fns -> yaml)")
    sp.add_argument("inputs", nargs="*", help="image filenames")
    sp.add_argument("--sock", default="/tmp/arslam.sock")
    sp.add_argument("-o", "--output", default="",
                    help="write yaml here (default: stdout)")
    sp.add_argument("--timeout", type=float, default=600.0)
    sp.set_defaults(fn=cmd_make_map)

    sp = sub.add_parser("replay", help="rebuild a map from an event log")
    sp.add_argument("log")
    sp.add_argument("-o", "--output", default="map.yaml")
    sp.add_argument("--redetect", action="store_true",
                    help="re-run the detector on the log's EMBEDDED images "
                         "(from serve --embed-images) instead of replaying "
                         "recorded detections")
    common(sp)
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("annotate", help="write annotated debug images")
    sp.add_argument("map")
    sp.add_argument("--out-dir", default="annotated")
    sp.add_argument("--all-tags", action="store_true")
    sp.set_defaults(fn=cmd_annotate)

    sp = sub.add_parser("audit", help="per-block reprojection audit "
                                      "(≙ compareProjections)")
    sp.add_argument("map")
    sp.add_argument("--limit", type=int, default=20,
                    help="show the N worst blocks (0 = all)")
    sp.add_argument("--json", action="store_true",
                    help="one JSON object per block instead of the table")
    sp.set_defaults(fn=cmd_audit)

    sp = sub.add_parser("scene", help="render the 3-D map scene to PNG")
    sp.add_argument("map")
    sp.add_argument("-o", "--output", default="scene.png")
    sp.set_defaults(fn=cmd_scene)

    args = p.parse_args(argv)
    _maybe_multihost(args)
    return args.fn(args)


def _maybe_multihost(args) -> None:
    """--platform / --multihost: join the multi-controller runtime.

    Every process runs the identical command; the host-side graph
    bookkeeping is a pure function of the inputs so all controllers issue
    the same device programs (parallel/multihost.py).  Secondary
    controllers write their artifacts to a scratch directory and mute
    stdout — only process 0 publishes results.
    """
    if getattr(args, "platform", ""):
        import jax

        jax.config.update("jax_platforms", args.platform)
    spec = getattr(args, "multihost", "")
    if not spec:
        return
    import jax

    from arslam.parallel import multihost

    pid, nproc = multihost.initialize(spec)
    if getattr(args, "devices", None) is None:
        args.devices = jax.device_count()
    logging.getLogger("arslam").info(
        "multihost: process %d/%d, %d global devices",
        pid, nproc, jax.device_count())
    if pid != 0:
        import tempfile

        scratch = tempfile.mkdtemp(prefix="arslam-mh-")
        # redirect per-process artifacts (map output AND xprof traces) so N
        # controllers never clobber each other's files
        for attr in ("output", "profile"):
            if getattr(args, attr, None):
                setattr(args, attr, os.path.join(
                    scratch, os.path.basename(getattr(args, attr))))
        sys.stdout = open(os.devnull, "w")


if __name__ == "__main__":
    sys.exit(main())
