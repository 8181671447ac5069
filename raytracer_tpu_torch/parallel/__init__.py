"""Multi-device rendering over ``torch.distributed`` (``sharding.py``)."""
