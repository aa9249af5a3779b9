"""The Python helpers behind the KNIME GCN-K nodes (``helpers.py``), the
port's copy of ``kgcn_tpu/knime``."""
