"""The benchmark's plain reference: kingjosephm/GAN's networks, jitter, draws
and Adam in float32 PyTorch (``nets``, ``steps``), each model's draws and
losses (``reference/<model>.py``), and its host path for a pair file
(``png``). It imports nothing of the program under test and takes nothing
the program made: the benchmark hands it the seed, the configuration and
the same raw inputs it hands the program."""
