from repro_torch.data.synthetic import (SyntheticClassification, SyntheticLM,
                                  class_batches, lm_batches)
