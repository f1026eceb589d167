"""Run the service: python -m oscillink_tpu_torch.service [--host H] [--port P] [--device D]."""

from __future__ import annotations

import argparse


def main() -> None:  # pragma: no cover
    parser = argparse.ArgumentParser(description="oscillink-tpu cloud service (PyTorch port)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()

    from .http import run

    run(host=args.host, port=args.port, device=args.device)


if __name__ == "__main__":
    main()
