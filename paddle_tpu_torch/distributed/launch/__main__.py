"""``python -m paddle_tpu_torch.distributed.launch``."""
from .main import main

if __name__ == "__main__":
    main()
