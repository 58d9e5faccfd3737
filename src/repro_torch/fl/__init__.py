"""Federated-learning helpers of the port (``repro.fl``): so far the channel
payload compression behind the wire codecs."""
