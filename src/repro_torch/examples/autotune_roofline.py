"""The paper end-to-end: autotune DGEMM + TRIAD, emit this device's
empirical Roofline model — no vendor spec sheet required.

  python -m repro_torch.examples.autotune_roofline [--full] [--csv F]
      [--device cpu]
"""

import argparse

from repro_torch.bench import roofline_model


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="paper Table I budgets (slow)")
    ap.add_argument("--csv", default=None, help="write roofline curve CSV")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    result = roofline_model.run(quick=not args.full, device=args.device)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(result["csv"])
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
