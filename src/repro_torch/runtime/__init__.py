from repro_torch.runtime.train_loop import TrainLoopCfg, train_loop

__all__ = ["TrainLoopCfg", "train_loop"]
