"""The scipy/numpy multigrid oracle (``mg_oracle.OracleMG``)."""
