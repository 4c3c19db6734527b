"""``python -m surface_multigrid_code_torch <cmd>``: the CLI (``cli.py``)."""

from surface_multigrid_code_torch.cli import main

if __name__ == "__main__":
    main()
