"""CLI front end of the PyTorch port — the flags and answer lines of
gnnpe_tpu/frontends/cli.py, plus ``--device``:

  python -m gnnpe_tpu_torch.frontends.cli \
      --file <dataset-dir> --data data_graph.graph \
      --query query_graph.graph --variant pe --mode online \
      -l 2 -e 2 -p 5 [-n MAX] [--workdir DIR] [--device cuda]

``-l`` keeps the reference's per-variant meaning (PE adds one, through
``PEConfig.from_cli``).  ``online`` answers through the device search
on ``--device`` (default cuda; there is no CPU fallback when CUDA is
missing — pass ``--device cpu`` to run the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gnnpe-tpu-torch",
        description="GNN-PE/GNN-PGE subgraph matching on one GPU")
    p.add_argument("-f", "--file", required=True,
                   help="dataset directory")
    p.add_argument("-d", "--data", default="data_graph.graph",
                   help="data graph (path or name under --file)")
    p.add_argument("-q", "--query", default="query_graph.graph",
                   help="query graph (path or name under --file)")
    p.add_argument("-m", "--mode", default="offline",
                   choices=["prepare", "offline", "online"])
    p.add_argument("-p", "--partition", type=int, default=5)
    p.add_argument("-l", "--length", type=int, default=2,
                   help="path length (PE: edges, +1 applied; PGE: vertices)")
    p.add_argument("-e", "--embedding", type=int, default=2)
    p.add_argument("-n", "--answers", default="MAX")
    p.add_argument("--variant", default="pe", choices=["pe", "pge"])
    p.add_argument("--engine", default="native",
                   choices=["auto", "native", "python"])
    p.add_argument("--workdir", default=None,
                   help="artifact dir (default: <file>/gnnpe-tpu)")
    p.add_argument("--partitioner", default="bfs",
                   choices=["bfs", "round_robin", "block"])
    p.add_argument("--device", default="cuda",
                   help="torch device for VDE and the search")
    return p


def _resolve(base: str, path: str) -> str:
    return path if os.path.isabs(path) or os.path.exists(path) \
        else os.path.join(base, path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from gnnpe_tpu_torch.config import PEConfig, PGEConfig
    from gnnpe_tpu_torch.embed.vde import gen_vde
    from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
    from gnnpe_tpu_torch.graph.csr import CSRGraph
    from gnnpe_tpu_torch.graph.partition import (partition_graph,
                                                 write_membership)
    from gnnpe_tpu_torch.index.packed import (PackedDominanceIndex,
                                              PGEPackedIndex, load_index,
                                              save_index)
    from gnnpe_tpu_torch.io.artifacts import ArtifactStore

    n = None if args.answers == "MAX" else int(args.answers)
    cfg_cls = PEConfig if args.variant == "pe" else PGEConfig
    config = cfg_cls.from_cli(l=args.length, e=args.embedding,
                              p=args.partition, n=n)

    data_path = _resolve(args.file, args.data)
    graph = CSRGraph.from_graph_file(data_path)
    print(f"|V|: {graph.num_vertices}, |E|: {graph.num_edges}, "
          f"|Σ|: {graph.labels_count}")

    workdir = args.workdir or os.path.join(args.file, "gnnpe-tpu")
    store = ArtifactStore(workdir)
    fp = store.fingerprint(config, data_path,
                           {"partitioner": args.partitioner})

    if args.mode == "prepare":
        membership = partition_graph(graph, config.partition_num,
                                     strategy=args.partitioner)
        store.save("membership", fp, membership=membership)
        write_membership(os.path.join(workdir, "membership.txt"),
                         graph, membership)
        print(f"membership written to {workdir}")
        return 0

    if args.variant == "pe":
        engine = PEEngine(config, graph, args.device)
        cached = store.load("paths", fp)
        if cached is not None and args.mode == "online":
            engine.paths = cached["paths"]
        else:
            engine.offline()
            store.save("paths", fp, paths=engine.paths)
            store.write_all_paths(os.path.join(workdir, "all_paths.txt"),
                                  engine.paths)
        if args.mode == "offline":
            print(f"{engine.paths.shape[0]} paths enumerated")
            return 0
        idx = load_index(store, "index", fp, PackedDominanceIndex)
        if idx is not None:
            engine.index = idx
        else:
            engine.build_index()
            save_index(store, "index", fp, engine.index)
    else:
        engine = PGEEngine(config, graph, args.device)
        cached = store.load("groups", fp)
        if cached is not None and args.mode == "online":
            engine.vertices = gen_vde(graph, config.vde_dim, args.device)
            engine.group = cached["group"]
            engine.label_group = cached["label_group"]
        else:
            engine.offline()
            store.save("groups", fp, group=engine.group,
                       label_group=engine.label_group)
        if args.mode == "offline":
            print("path groups built")
            return 0
        idx = load_index(store, "pge-index", fp, PGEPackedIndex)
        if idx is not None:
            engine.index = idx
        else:
            engine.build_index()
            save_index(store, "pge-index", fp, engine.index)

    engine.attach_device(args.device)
    query = CSRGraph.from_graph_file(_resolve(args.file, args.query))
    t0 = time.perf_counter()
    res = engine.online(query, engine=args.engine)
    dt = (time.perf_counter() - t0) * 1e3
    label = "Answer Number" if args.variant == "pe" else "Answer Num"
    print(f"{label}: {res.answer_count} Query Time (ms): {dt:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
