"""`python -m mine_tpu_torch.serving` == `python -m mine_tpu_torch.serving.server`."""

from mine_tpu_torch.serving.server import main

if __name__ == "__main__":
    main()
