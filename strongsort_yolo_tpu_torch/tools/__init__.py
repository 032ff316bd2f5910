"""Tools of the port: measurement on a CUDA device (prof_conv,
prof_resample, sass, sync_count) and offline tracking (eval_mot,
eval_sequence, train_aflink, make_mot_fixture)."""
