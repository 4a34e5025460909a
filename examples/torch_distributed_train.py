"""Distributed data- and tensor-parallel training on the port, in gloo
ranks spawned on this host (the card by default, every rank on it; or
--device cpu):

    PYTHONPATH=src python examples/torch_distributed_train.py [--device cpu]

Phase 1: four ranks as a (2, 2) mesh, 2-way DP x 2-way TP (the trainer's
CLI with --model-axis 2: `ShardingRules` places params, the ZeRO-1
optimizer state and the batch), five steps, a checkpoint of the global
content.  Phase 2: half the ranks "fail"; two ranks resume the same
checkpoint on a (2, 1) mesh (elastic: each restores its own shards) and
train on, on the same data stream.
"""
import argparse
import os
import socket
import tempfile


def _rank(rank, argv):
    import torch

    from repro_torch.launch import train

    if "cpu" in argv:
        torch.set_num_threads(1)        # the ranks share the host's cores
    return train.main(argv)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run(world: int, argv) -> list:
    """`launch.train.main(argv)` in `world` spawned gloo ranks."""
    from repro_torch.distributed.process_group import spawn_ranks

    return spawn_ranks(_rank, world, (argv,), env={
        "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())},
        timeout=900.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="torch_dist_ck_") as ckdir:
        common = ["--arch", args.arch, "--reduced", "--seq-len", "64",
                  "--batch", "8", "--lr", "1e-3", "--steps", str(args.steps),
                  "--log-every", "1", "--device", args.device,
                  "--dist-backend", "gloo", "--ckpt-dir", ckdir]
        half = args.steps // 2
        print("phase 1: 2-way DP x 2-way TP in four ranks", flush=True)
        rcs = run(4, common + ["--model-axis", "2", "--stop-after",
                               str(half)])
        assert rcs == [0] * 4, rcs
        print(f"checkpointed: {sorted(os.listdir(ckdir))}", flush=True)
        print("phase 2: elastic resume in two ranks, 2-way DP x 1-way TP",
              flush=True)
        rcs = run(2, common)
        assert rcs == [0] * 2, rcs
    print("OK — same stream, new mesh, training continued.")


if __name__ == "__main__":
    main()
