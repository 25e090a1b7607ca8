"""The port's own copies of the repo's tools that its modules import:
``mvplan``, the placement advisor the capacity worker runs over a
scraped fleet (``python -m multiverso_tpu_torch.tools.mvplan``)."""
