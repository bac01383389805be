"""The plain reference that decides ``correct``: ``regnet_ref``, a frozen
copy of the port's plain paths, and ``checks``, the numbers compared.
Imports neither JAX nor the JAX package nor anything of the port."""
