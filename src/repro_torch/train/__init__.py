from repro_torch.train.step import TrainStepBuilder, cross_entropy
