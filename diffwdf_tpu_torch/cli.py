"""Command-line entry points for the port's workloads.

The JAX package's ten subcommands (``diffwdf_tpu/cli.py``), with their
flags, defaults and choices, on the port:

    python -m diffwdf_tpu_torch.cli pretrain --diode 1u1d --layers 2 --width 16
    python -m diffwdf_tpu_torch.cli train-clipper --synthetic --diode 1u1d ...
    python -m diffwdf_tpu_torch.cli simulate --circuit tube_screamer --drive 0.8
    python -m diffwdf_tpu_torch.cli process --input in.wav --engine deer --warmup
    python -m diffwdf_tpu_torch.cli export-artifact --model 4 --check
    python -m diffwdf_tpu_torch.cli run-artifact --artifact a.pt2 --input in.wav
    python -m diffwdf_tpu_torch.cli bench

Everything runs on the card; the global ``--device cpu`` (in place of the
JAX package's ``--platform``) runs it on the CPU, where the kernel wrappers
run their plain versions.  With no card and no ``--device cpu`` a command
refuses to start.  Each command prints one JSON line with a ``"device"``
key (``pretrain`` and ``train-clipper`` also say where they saved).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

DIODES = {
    "default": "default_diode",
    "1u1d": "diode_1n4148_1u1d",
    "1u2d": "diode_1n4148_1u2d",
    "1u3d": "diode_1n4148_1u3d",
    "2u2d": "diode_1n4148_2u2d",
    "2u3d": "diode_1n4148_2u3d",
    "3u3d": "diode_1n4148_3u3d",
    "oa1154": "diode_oa1154_1u1d",
}

#: the bench headline's configuration (bench.py:292-296, :1317-1326) and
#: the number of timed calls
BENCH_FS, BENCH_R, BENCH_CAP = 96000.0, 47.0e3, 2.2e-9
BENCH_B, BENCH_T, BENCH_REPS = 8192, 2048, 20


def _diode(name):
    import diffwdf_tpu_torch.roots.diode as d

    return getattr(d, DIODES[name])


def _to(tree, device):
    """A params tree with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _emit(rec, args, **kw):
    print(json.dumps({**rec, "device": args.device}, **kw), flush=True)


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cmd_pretrain(args):
    from .analysis import plot_history, plot_transconductance
    from .nn.serialization import save_model_json
    from .training.pretrain import PretrainConfig, evaluate_pretrained, pretrain_diode

    diode = _diode(args.diode)
    print(f"device: {args.device}")
    cfg = PretrainConfig(
        n_layers=args.layers,
        layer_size=args.width,
        epochs=args.epochs,
        learning_rate=args.lr,
        batch_size=args.batch_size,
        seed=args.seed,
        schedule=args.schedule,
        matmul_precision=args.precision,
    )
    params, acts, metrics = pretrain_diode(diode, cfg, device=args.device)
    final = evaluate_pretrained(params, acts, diode, cfg, device=args.device)
    _emit({"diode": diode.name, "arch": f"{args.layers}x{args.width}", **final}, args)
    out = args.out or f"{diode.name}_{args.layers}x{args.width}_pretrained_model.json"
    save_model_json(params, acts, out)
    print(f"saved {out}")
    if args.plots_dir:
        os.makedirs(args.plots_dir, exist_ok=True)
        hist = {k: list(np.asarray(v)) for k, v in metrics.items()}
        plot_history(hist, os.path.join(args.plots_dir, "pretrain_history.png"))
        plot_transconductance(params, acts, diode,
                              os.path.join(args.plots_dir, "transconductance.png"))


def cmd_train_clipper(args):
    import glob

    from .analysis import plot_history
    from .data.dataimport import load_diode_data
    from .data.synthetic import make_synthetic_dataset_dir
    from .models.diode_clipper import make_training_clipper
    from .nn.serialization import load_model_json, save_model_json
    from .roots.neural import NeuralDiodeRoot
    from .training.checkpoint import save_checkpoint
    from .training.circuit_train import CircuitTrainConfig, make_clipper_batches, train_clipper
    from .training.metrics import MetricsLogger

    dev = args.device
    diode = _diode(args.diode)
    if args.synthetic or not args.data_dir:
        data_dir = args.data_dir or "synthetic_dataset"
        family = "1N4148" if "1N4148" in diode.name else diode.name.split()[0]
        sub = os.path.join(data_dir, family, f"{diode.N_up}up{diode.N_down}down")
        if not glob.glob(os.path.join(sub, "*.csv")):
            print(f"synthesizing dataset under {data_dir} ...")
            make_synthetic_dataset_dir(data_dir, diode, fs=args.fs, duration_s=18.0, device=dev)
        base = data_dir
    else:
        base = args.data_dir
    train, val, fs = load_diode_data(diode, base)
    print(f"train {len(train['x'])} samples, val {len(val['x'])}, fs {fs}")
    if len(train["x"]) == 0:
        raise SystemExit(f"no training data found under {base}")

    if args.pretrained:
        mlp, acts, _ = load_model_json(args.pretrained, device=dev)
        root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    else:
        root = NeuralDiodeRoot(name="dp", n_layers=args.layers, layer_size=args.width)
        frag = root.init_params(dev, torch.Generator().manual_seed(args.seed))
    circuit = make_training_clipper(root, fs, cap=args.cap)
    params = {**circuit.init_params(dev), **frag}

    cfg = CircuitTrainConfig(
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        max_chunks=args.max_chunks,
        engine=args.engine,
    )
    # the clipper's fused engine needs every chunk's R hoisted, so
    # file-boundary chunks (mixed R) are dropped there; scan and
    # fused_generic keep every chunk (as the JAX command does)
    drop_mixed = args.engine == "fused"
    tb = make_clipper_batches(train, cfg.batch_size, cfg.max_chunks, drop_mixed_r=drop_mixed,
                              device=dev)
    vb = (make_clipper_batches(val, cfg.batch_size, cfg.max_chunks, drop_mixed_r=drop_mixed,
                               device=dev)
          if len(val["x"]) else None)

    logger = MetricsLogger(args.log or "train_clipper.jsonl", print_every=args.log_every)

    def on_epoch(epoch, p, hist):
        logger.log(epoch, samples=int(tb["x"].numel()),
                   **{k: v[-1] for k, v in hist.items() if v})
        if args.ckpt_dir:
            save_checkpoint(os.path.join(args.ckpt_dir, f"step_{epoch}"), p, step=epoch)

    t0 = time.perf_counter()
    params, hist = train_clipper(circuit, params, tb, vb, cfg,
                                 trainable_filter=lambda p: p["dp"], on_epoch=on_epoch)
    seconds = time.perf_counter() - t0
    logger.close()
    out = args.out or f"{diode.name}_{args.layers}x{args.width}_circuit_trained.json"
    save_model_json(params["dp"], root.activations, out)
    print(f"saved {out}; final loss {hist['loss'][-1]:.6g}")
    if args.plots_dir:
        os.makedirs(args.plots_dir, exist_ok=True)
        plot_history(hist, os.path.join(args.plots_dir, "clipper_history.png"))
    _emit({"out": out, "engine": args.engine, "epochs": args.epochs,
           "train_chunks": int(tb["x"].shape[0]),
           "val_chunks": int(vb["x"].shape[0]) if vb is not None else 0,
           "loss": hist["loss"], "val_loss": hist["val_loss"], "train_s": seconds}, args)


def _simulate_circuit(args, root, fs):
    from .models.diode_clipper import make_diode_clipper, make_hpf_diode_clipper
    from .models.tube_screamer import make_tube_screamer

    if args.circuit == "clipper":
        return make_diode_clipper(root, fs), "Vs"
    if args.circuit == "hpf_clipper":
        return make_hpf_diode_clipper(root, fs), "Vs"
    return make_tube_screamer(root, fs, drive=args.drive), "Vin"


def cmd_simulate(args):
    from .nn.serialization import load_model_json
    from .roots.diode import DiodePairRoot
    from .roots.neural import NeuralDiodeRoot

    dev = args.device
    if args.model_json:
        mlp, acts, _ = load_model_json(args.model_json, device=dev)
        root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    else:
        root = DiodePairRoot(name="dp", diode=_diode(args.diode), quality=args.quality)
        frag = root.init_params(dev)

    fs = args.fs
    if args.input and args.input.lower().endswith(".wav"):
        from .data.audio import read_wav

        fs, x = read_wav(args.input)  # the circuit is built at the file's rate
        x = (args.amp * x).astype(np.float32)
    elif args.input:
        x = np.load(args.input).astype(np.float32)
    else:
        n = np.arange(int(args.seconds * fs))
        x = (args.amp * np.sin(2 * np.pi * args.freq * n / fs)).astype(np.float32)
    ckt, node = _simulate_circuit(args, root, fs)
    params = {**ckt.init_params(dev), **frag}
    xt = torch.from_numpy(x).to(dev)

    if args.engine == "scan":
        out, _ = ckt.process(params, ckt.init_state(dev), {node: {"v": xt}})
    elif args.engine == "fused":
        # B7 at B = 1: the generated kernel of the circuit on one stream
        from .ops.fused_circuit import fused_circuit_process

        st0 = {k: {f: z.reshape(1) for f, z in d.items()} for k, d in ckt.init_state(dev).items()}
        o, _ = fused_circuit_process(ckt, params, xt[None], st0, input_node=node)
        out = o[0]
    elif args.engine == "pint":
        from .ops.parallel_time import parallel_time_process

        out = parallel_time_process(ckt, params, {node: {"v": xt}}, device=dev)
    else:  # native: the circuit's generated forward built for the host
        from .ops.circuit_codegen import state_order
        from .ops.fused_circuit import prepare
        from .ops.registry import host_run

        p_cpu = _to(params, "cpu")
        prep = prepare(ckt, p_cpu, "cpu", input_node=node)
        st = ckt.init_state("cpu")
        z0 = torch.stack([st[n][f].reshape(1) for n, f in state_order(ckt)])
        o, _ = host_run(prep.prog.host_source, torch.from_numpy(x)[None], z0, prep.vec,
                        prep.rows, prep.times, prep.warr)
        out = o[0]
    out = out.detach().cpu().numpy().astype(np.float32)
    out_path = args.out or "sim_out.npy"
    if out_path.lower().endswith(".wav"):
        from .data.audio import write_wav

        write_wav(out_path, fs, out)
    else:
        np.save(out_path, out)
    _emit({"samples": len(out), "engine": args.engine, "peak": float(np.max(np.abs(out))),
           "rms": float(np.sqrt(np.mean(out**2))), "out": out_path}, args)


def cmd_process(args):
    """Plugin-parity serving: stream an audio file through the full plugin
    processor (circuit choice + gain/cutoff/drive parameters, block-wise with
    carried state)."""
    from .data.audio import read_wav, write_wav
    from .runtime.stream import make_plugin_processor

    if args.input.lower().endswith(".wav"):
        fs, x = read_wav(args.input)
    else:
        fs = args.fs
        x = np.load(args.input).astype(np.float32)

    # zoo 0-6 are the clipper group's choices, 7-11 the multi-diode group's
    circuit, model = args.circuit, args.model
    if circuit == "clipper" and model is not None and model >= 7:
        circuit, model = "multi_diode_clipper", model - 7
    clipper_zoo = args.model if args.circuit == "clipper" else None
    clipper_json = args.model_json if (clipper_zoo or 0) >= 2 else None
    proc = make_plugin_processor(
        fs, cutoff_hz=args.cutoff, drive=args.drive, mlp_json=args.model_json,
        clipper_zoo=clipper_zoo, clipper_json=clipper_json, engine=args.engine,
        device=args.device,
    )
    knobs = {"drive": args.drive} if circuit == "tube_screamer" else {"cutoff_hz": args.cutoff}
    if model is not None:
        knobs["model"] = model

    block = args.block
    warmup_s = 0.0
    if args.warmup:
        # prepareToPlay parity: build every block variant's kernels of the
        # served circuit (members, engine, fallback) before the stream starts
        warmup_s = proc.warmup([block], circuits=(circuit,))["seconds"]
    xp = np.pad(x, (0, (-len(x)) % block))
    outs = [proc.process_block(xp[i: i + block], circuit, gain_db=args.gain_db, **knobs)
            for i in range(0, len(xp), block)]
    out = np.concatenate(outs)[: len(x)]

    out_path = args.out or "processed.wav"
    if out_path.lower().endswith(".wav"):
        write_wav(out_path, fs, out)
    else:
        np.save(out_path, out)
    _emit({"samples": len(out), "fs": fs, "circuit": circuit, "blocks": len(outs),
           "load": round(proc.load, 4), "warmup_s": round(warmup_s, 3),
           "peak": float(np.max(np.abs(out))), "out": out_path}, args)


def cmd_params(args):
    """Reflect the parameter schema of every circuit in a processor set (the
    reference's auto-generated GUI, ``CircuitModelGUI.cpp:55-66``, as JSON)."""
    from .runtime.stream import make_clipper_processor, make_hpf_processor, make_plugin_processor

    make = {"plugin": make_plugin_processor, "clipper": make_clipper_processor,
            "hpf": make_hpf_processor}[args.set]
    proc = make(args.fs, device=args.device)
    schema = {name: [s.to_dict() for s in proc.param_specs(name)] for name in proc.surfaces()}
    _emit({"set": args.set, "fs": args.fs, "circuits": schema}, args,
          indent=2 if args.pretty else None)


def _export_circuit(args, dev):
    """(circuit, params, input node) of the export-artifact command."""
    from .models.diode_clipper import cutoff_to_resistance, make_diode_clipper, make_root_from_zoo

    if args.circuit == "clipper":
        root, frag = make_root_from_zoo(args.model, json_path=args.model_json, device=dev)
        cap = 2.2e-9
        ckt = make_diode_clipper(root, args.fs, r_source=cutoff_to_resistance(args.cutoff, cap),
                                 cap=cap)
        return ckt, {**ckt.init_params(dev), **frag}, "Vs"
    from .models.tube_screamer import make_tube_screamer
    from .roots.diode import DiodePairRoot
    from .roots.neural import NeuralDiodeRoot

    if args.model_json:
        from .nn.serialization import load_model_json

        mlp, acts, _ = load_model_json(args.model_json, device=dev)
        root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    else:
        root = DiodePairRoot(name="dp")
        frag = root.init_params(dev)
    ckt = make_tube_screamer(root, args.fs, drive=args.drive)
    return ckt, {**ckt.init_params(dev), **frag}, "Vin"


def cmd_export_artifact(args):
    """Export a circuit (weights baked in) as a self-contained torch.export
    serving artifact: the analog of the reference's train -> JSON ->
    plugin-binary deploy pipeline (``plugin/src/CMakeLists.txt:16-34``)."""
    from .runtime.artifact import load_artifact, save_artifact

    ckt, params, node = _export_circuit(args, args.device)
    out_path = args.out or f"{args.circuit}_artifact.pt2"
    t0 = time.perf_counter()
    meta = save_artifact(out_path, ckt, params, input_node=node, block_len=args.block,
                         fs=args.fs)
    result = {"out": out_path, **meta, "bytes": os.path.getsize(out_path),
              "export_s": time.perf_counter() - t0}
    if args.check:
        art = load_artifact(out_path, device=args.device)
        n = np.arange(4 * args.block)
        x = (2.0 * np.sin(2 * np.pi * 220.0 * n / args.fs)).astype(np.float32)
        y = art.run(x)
        ref, _ = ckt.process(params, ckt.init_state(args.device),
                             {node: {"v": torch.from_numpy(x).to(args.device)}})
        result["check_max_abs_err"] = float(np.max(np.abs(y - ref.cpu().numpy())))
    _emit(result, args)


def cmd_plot(args):
    """Analysis plots: the reference's two plotting scripts
    (``plot_history.py``, ``plot_transconductance.py``)."""
    from . import analysis

    if args.what == "history":
        hist = analysis.load_history(args.history)
        out = args.out or "history.png"
        analysis.plot_history(hist, out, title=args.title or "Training history")
        rec = {"plot": "history", "epochs": len(hist.get("loss", [])), "out": out}
    else:  # transconductance
        from .nn.serialization import load_model_json

        mlp, acts, _ = load_model_json(args.model_json, device="cpu")
        diode = _diode(args.diode)
        out = args.out or "transconductance.png"
        analysis.plot_transconductance(mlp, acts, diode, out, r=args.r)
        err = analysis.transconductance_error(mlp, acts, diode)
        rec = {"plot": "transconductance", "diode": diode.name,
               "physics_rms_rel_err": err, "out": out}
    _emit(rec, args)


def cmd_run_artifact(args):
    """Serve audio from an artifact alone: no circuit definition, params or
    training stack (the deployment half of ``export-artifact``)."""
    from .data.audio import read_wav, write_wav
    from .runtime.artifact import load_artifact

    art = load_artifact(args.artifact, device=args.device)
    if args.input.lower().endswith(".wav"):
        fs, x = read_wav(args.input)
    else:
        fs = art.meta.get("fs") or 48000.0
        x = np.load(args.input).astype(np.float32)
    y = art.run(x)
    out_path = args.out or "artifact_out.wav"
    if out_path.lower().endswith(".wav"):
        write_wav(out_path, fs, y)
    else:
        np.save(out_path, y)
    _emit({"samples": len(y), "fs": fs, "block_len": art.block_len,
           "peak": float(np.max(np.abs(y))), "out": out_path}, args)


def cmd_fit_components(args):
    import scipy.signal as sig

    import diffwdf_tpu_torch as tw
    from .training.circuit_train import fit_components

    dev, fs = args.device, args.fs
    if args.circuit == "divider":
        R1 = tw.Resistor("R1", 2.0e3, trainable=True)
        R2 = tw.Resistor("R2", 100.0, trainable=True)
        tree = tw.Inverter("I1", tw.Series("S1", R1, R2))
        ckt = tw.Circuit(tree=tree, root=tw.IdealVoltageSourceRoot("Vs"), fs=fs,
                         outputs=("R1",))
        n = np.arange(512)
        vin = np.sin(2 * np.pi * 100 * n / fs).astype(np.float32)
        target = 0.5 * vin
        lrs = {"R1.R": 25.0, "R2.R": 25.0}
    else:  # lpf
        R1 = tw.Resistor("R1", 1000.0, trainable=True)
        C1 = tw.Capacitor("C1", 1.0e-6, trainable=True)
        tree = tw.Inverter("I1", tw.Series("S1", R1, C1))
        ckt = tw.Circuit(tree=tree, root=tw.IdealVoltageSourceRoot("Vs"), fs=fs,
                         outputs=("C1",))
        T = 1280
        t = np.arange(T) / fs
        k = T / fs / np.log(100.0)
        sweep = np.sin(2 * np.pi * 100.0 * k * (np.exp(t / k) - 1)).astype(np.float32)
        rc = 1.0 / (2 * np.pi * 720.0)
        b, a = sig.bilinear([1.0], [rc, 1.0], fs=fs)
        vin = sweep
        target = sig.lfilter(b, a, sweep).astype(np.float32)
        lrs = {"R1.R": 25.0, "C1.C": 10.0e-9}

    params, hist = fit_components(
        ckt, ckt.init_params(dev), {"Vs": {"v": torch.from_numpy(vin).to(dev)}},
        torch.from_numpy(np.asarray(target, np.float32)).to(dev), lrs, epochs=args.epochs)
    _emit({"loss": hist["loss"][-1], "params": hist["params"][-1]}, args)


def cmd_bench(args):
    """The JAX bench's headline on the port: diode_clipper_neural2x16_throughput_per_chip,
    the LPF clipper with zoo 4's 2x16 root served by B1 at (B, T) = (8192,
    2048), 96 kHz, 47 kOhm, 2.2 nF (bench.py:292-296), N(0, 2^2) input;
    the median of BENCH_REPS timed calls (CUDA events on the card, the host
    clock on the CPU)."""
    from .models.diode_clipper import make_root_from_zoo
    from .ops.fused_clipper import fused_clipper_neural

    dev = torch.device(args.device)
    root, frag = make_root_from_zoo(4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    vins = [2.0 * torch.randn(BENCH_B, BENCH_T, generator=gen, device=dev) for _ in range(4)]
    z0 = torch.zeros(BENCH_B, device=dev)

    def call(i):
        return fused_clipper_neural(vins[i % 4], z0, frag["dp"], BENCH_R, BENCH_CAP, fs=BENCH_FS)

    out, _ = call(0)  # the first call builds or loads the kernel library
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("bench: non-finite output")
    times = []
    for i in range(BENCH_REPS):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call(i)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            call(i)
            times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    _emit({"metric": "diode_clipper_neural2x16_throughput_per_chip",
           "value": BENCH_B * BENCH_T / ms / 1e3, "unit": "Msamples/s", "ms": ms,
           "B": BENCH_B, "T": BENCH_T, "fs": BENCH_FS, "reps": BENCH_REPS,
           "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
           "card": _card() if dev.type == "cuda" else None}, args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="diffwdf_tpu_torch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default: the card; cpu runs the kernels' plain "
                        "versions)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("pretrain", help="synthetic diode pretraining")
    sp.add_argument("--diode", default="1u1d", choices=DIODES)
    sp.add_argument("--layers", type=int, default=2)
    sp.add_argument("--width", type=int, default=16)
    sp.add_argument("--epochs", type=int, default=2000)
    sp.add_argument("--lr", type=float, default=2e-5)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--schedule", default="const", choices=("const", "cosine"))
    sp.add_argument("--precision", default="default", choices=("default", "high", "highest"),
                    help="matmul precision; 'high' allows TF32 on the card, 'default' and "
                         "'highest' keep full f32")
    sp.add_argument("--out")
    sp.add_argument("--plots-dir")
    sp.set_defaults(fn=cmd_pretrain)

    sp = sub.add_parser("train-clipper", help="circuit-in-the-loop training")
    sp.add_argument("--diode", default="1u1d", choices=DIODES)
    sp.add_argument("--data-dir")
    sp.add_argument("--synthetic", action="store_true")
    sp.add_argument("--pretrained")
    sp.add_argument("--layers", type=int, default=2)
    sp.add_argument("--width", type=int, default=16)
    sp.add_argument("--epochs", type=int, default=501)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--batch-size", type=int, default=2048)
    sp.add_argument("--max-chunks", type=int)
    sp.add_argument("--engine", default="scan", choices=("scan", "fused", "fused_generic"),
                    help="fused = the clipper's forward and adjoint kernels (B3, B4; hoisted "
                         "per-chunk R); fused_generic = the generated forward and adjoint "
                         "kernels (B7, B8; per-row and per-sample pot streams)")
    sp.add_argument("--cap", type=float, default=4.7e-9)
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out")
    sp.add_argument("--log")
    sp.add_argument("--log-every", type=int, default=5)
    sp.add_argument("--ckpt-dir")
    sp.add_argument("--plots-dir")
    sp.set_defaults(fn=cmd_train_clipper)

    sp = sub.add_parser("simulate", help="run a circuit on a signal")
    sp.add_argument("--circuit", default="clipper",
                    choices=("clipper", "hpf_clipper", "tube_screamer"))
    sp.add_argument("--diode", default="1u1d", choices=DIODES)
    sp.add_argument("--quality", default="best", choices=("best", "good", "low"))
    sp.add_argument("--model-json")
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.add_argument("--freq", type=float, default=220.0)
    sp.add_argument("--amp", type=float, default=1.0)
    sp.add_argument("--seconds", type=float, default=1.0)
    sp.add_argument("--drive", type=float, default=0.5)
    sp.add_argument("--input", help=".npy or .wav input signal (WAV is mono-summed; its "
                    "sample rate overrides --fs)")
    sp.add_argument("--engine", default="scan", choices=("scan", "fused", "pint", "native"),
                    help="execution engine: Circuit.process, the generated kernel (B7) on "
                         "one stream, the parallel-in-time Newton solver, or the generated "
                         "forward built for the host")
    sp.add_argument("--out", help="output path (.npy, or .wav for mono float32 audio)")
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("process",
                        help="stream audio through the plugin processor (gain/cutoff/drive)")
    sp.add_argument("--input", required=True, help=".wav or .npy audio")
    sp.add_argument("--circuit", default="clipper",
                    choices=("clipper", "multi_diode_clipper", "tube_screamer"))
    sp.add_argument("--gain-db", type=float, default=0.0)
    sp.add_argument("--cutoff", type=float, default=4000.0,
                    help="clipper cutoff Hz (200-20k, sets source R)")
    sp.add_argument("--drive", type=float, default=0.5, help="tube screamer drive pot (0-1)")
    sp.add_argument("--model", type=int, choices=range(12), metavar="0-11",
                    help="clipper root from the 12-entry model zoo (0 TOMS, 1 approx, 2-6 "
                         "neural 1U-1D sizes, 7-11 multi-diode 2x16); neural entries load "
                         "the pretrained zoo weights when present")
    sp.add_argument("--model-json",
                    help="neural-root weights (tube screamer, or clipper with --model >= 2)")
    sp.add_argument("--block", type=int, default=2048)
    sp.add_argument("--fs", type=float, default=48000.0, help="sample rate for .npy inputs")
    sp.add_argument("--engine", default="scan", choices=("scan", "deer"),
                    help="deer = parallel-in-time serving (B5, B9) for blocks divisible by "
                         "1024; others, and flagged blocks, get the exact engine")
    sp.add_argument("--warmup", action="store_true",
                    help="build every block variant's kernels of the served circuit before "
                         "streaming (prepareToPlay parity)")
    sp.add_argument("--out", help="output path (.wav or .npy)")
    sp.set_defaults(fn=cmd_process)

    sp = sub.add_parser("params", help="print the per-circuit parameter schema (GUI reflection)")
    sp.add_argument("--set", default="plugin", choices=("plugin", "clipper", "hpf"))
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.add_argument("--pretty", action="store_true")
    sp.set_defaults(fn=cmd_params)

    sp = sub.add_parser("export-artifact",
                        help="export a circuit as a self-contained torch.export serving artifact")
    sp.add_argument("--circuit", default="clipper", choices=("clipper", "tube_screamer"))
    sp.add_argument("--model", type=int, default=0, choices=range(12), metavar="0-11",
                    help="clipper root from the model zoo")
    sp.add_argument("--model-json", help="neural-root weights JSON")
    sp.add_argument("--cutoff", type=float, default=4000.0)
    sp.add_argument("--drive", type=float, default=0.5)
    sp.add_argument("--block", type=int, default=2048)
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.add_argument("--out", help="output artifact path (default <circuit>_artifact.pt2)")
    sp.add_argument("--check", action="store_true",
                    help="reload the artifact and cross-check against the live scan engine")
    sp.set_defaults(fn=cmd_export_artifact)

    sp = sub.add_parser("plot", help="analysis plots (history / transconductance)")
    sp.add_argument("what", choices=("history", "transconductance"))
    sp.add_argument("--history", help="history .pkl or metrics .jsonl")
    sp.add_argument("--model-json", help="neural-root weights JSON")
    sp.add_argument("--diode", default="1u1d", choices=DIODES)
    sp.add_argument("--r", type=float, default=100.0,
                    help="port resistance for transconductance extraction")
    sp.add_argument("--title", help="history plot title")
    sp.add_argument("--out", help="output .png path")
    sp.set_defaults(fn=cmd_plot)

    sp = sub.add_parser("run-artifact",
                        help="serve audio from an artifact (no circuit code needed); "
                             "a Tube Screamer or other generated-circuit artifact holds C++ "
                             "and CUDA sources that are compiled and run, so load only "
                             "trusted files")
    sp.add_argument("--artifact", required=True, help="artifact path")
    sp.add_argument("--input", required=True, help=".wav or .npy audio")
    sp.add_argument("--out", help="output path (.wav or .npy)")
    sp.set_defaults(fn=cmd_run_artifact)

    sp = sub.add_parser("fit-components", help="learn R/C values (sanity workloads)")
    sp.add_argument("--circuit", default="divider", choices=("divider", "lpf"))
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.set_defaults(fn=cmd_fit_components)

    sp = sub.add_parser("bench", help="the bench headline: B1 throughput")
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("diffwdf_tpu_torch: no CUDA device found; pass --device cpu to run "
                         "on the CPU")
    args.fn(args)


if __name__ == "__main__":
    main()
