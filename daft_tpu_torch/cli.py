"""Command-line interface (reference engine: ``src/daft-cli``, the ``daft
dashboard`` subcommand).

Usage: ``python -m daft_tpu_torch.cli dashboard [--port N]``
       ``python -m daft_tpu_torch.cli version``
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="daft-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    dash = sub.add_parser("dashboard", help="serve the query dashboard")
    dash.add_argument("--port", type=int, default=None)
    sub.add_parser("version", help="print the version")
    args = parser.parse_args(argv)

    if args.cmd == "version":
        from . import __version__
        print(__version__)
        return 0
    from . import dashboard
    port = dashboard.launch(args.port if args.port is not None
                            else dashboard.DEFAULT_PORT)
    print(f"daft-tpu-torch dashboard on http://127.0.0.1:{port}",
          flush=True)
    try:
        import time
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        dashboard.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
