from mridc_tpu_torch.models.quantitative.qcirim import qCIRIM, qRIMBlock
from mridc_tpu_torch.models.quantitative.qvn import qVarNet
from mridc_tpu_torch.models.quantitative.signal_model import (analytical_log_likelihood_gradient, fit_megre_maps,
                                                              megre_signal, megre_signal_complex, rescale_by_max)

__all__ = ["qCIRIM", "qRIMBlock", "qVarNet", "megre_signal", "megre_signal_complex",
           "analytical_log_likelihood_gradient", "fit_megre_maps", "rescale_by_max"]
