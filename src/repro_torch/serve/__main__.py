"""``python -m repro_torch.serve`` — run the analytics gateway standalone."""
from .app import main

if __name__ == "__main__":
    main()
