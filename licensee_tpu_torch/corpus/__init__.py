from licensee_tpu_torch.corpus.fields import LicenseField
from licensee_tpu_torch.corpus.meta import LicenseMeta
from licensee_tpu_torch.corpus.license import License

__all__ = ["License", "LicenseField", "LicenseMeta"]
