"""Launchers of the port: ``serve`` (batched prefill and decode), ``train``
(the federated train step, ``steps``) and the meshes of virtual clients."""
