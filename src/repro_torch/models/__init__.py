"""Model blocks of the port: the recurrent RWKV6 and Mamba layers that
recurrent serving (:mod:`repro_torch.serve.recurrent_lm`) runs, and the
common pieces they share."""
