"""`python -m acoss_tpu_torch` -> the CLI (benchmark)."""

from acoss_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
